"""The port's public surface against the JAX package's, by name and signature.

For each of the 31 modules the two packages share, the public surface of a
module is what it defines (classes and functions whose ``__module__`` is that
module, not starting with ``_``) and what its ``__all__`` exports; a name it
imports only to use is not part of it. This file walks both packages with
``inspect`` and computes nothing:

* every public name of the JAX module has a counterpart of that name in the
  port's module. A function or class takes JAX's parameters in JAX's order,
  of the same kinds, then at most ``device`` and the port's own parameters;
* every public method of a JAX class (``get_params``, ``set_params``,
  ``get_metadata_routing``, each ``set_*_request``, ``__sklearn_tags__`` and
  ``fit_transform`` among them) is on the port's class, at the same rule for
  its parameters, and on a default instance wherever it is on JAX's;
* the other way round, every public name, method and parameter of the port
  that JAX lacks is listed in ``PORT_ONLY``.

What the port leaves out is listed in ``EXCEPTIONS``, each entry with its
reason. An entry is a name, ``"<module>.<name>"`` for a module's name or
``"<module>.<Class>.<method>"`` for a method of a class and the classes that
inherit it, or a pair of such a name and a parameter. The two lists hold
nothing else: an entry that names no difference between the packages fails
``test_no_dead_entries``, so removing any entry fails a module's case.
"""

import functools
import importlib
import inspect

import pytest

import enstop_torch  # noqa: F401  (both packages import before the walk)
import enstop_tpu  # noqa: F401

MODULES = (
    "", "models.plsa", "models.base", "models.ensemble", "models.streamed", "models.mesh",
    "models.accelerated", "ops.driver", "ops.sell", "ops.fit", "ops.init", "ops.nmf",
    "ops.metrics", "ops.em", "ops.coo", "ops.data", "cluster.distances", "cluster.umap",
    "cluster.hdbscan", "parallel.mesh", "parallel.sparse_mesh", "plsa", "cuda_plsa",
    "block_parallel_plsa", "distributed_plsa", "streamed_plsa", "enstop_", "utils",
    "synthetic", "datasets", "profiling",
)
JAX, PORT = "enstop_tpu", "enstop_torch"

# what the port leaves out, and why: TPU layouts and compile knobs with no
# counterpart on the card, and scikit-learn's set_output
SELL = "the TPU's SELL layout (lane-padded slices); the port's sparse corpus is CSR and CSC"
SELL_DEV = "the TPU's device SELL arrays; the port takes its PreparedSell as prep in their place"
SEGSUM = "picks XLA's gather or scatter segment sum on the TPU; the port's passes are kernels"
INNER = "picks XLA matmuls or Pallas kernels as the mesh's inner step; the port's is its kernels"
EXCEPTIONS = {
    "ops.sell.SellSides": SELL,
    "ops.sell.pack_sell": SELL,
    "ops.sell.pad_rows": SELL,
    "ops.sell.device_arrays": SELL,
    ("ops.sell.PreparedSell", "dev"): SELL_DEV,
    ("ops.sell.PreparedSell", "lane"): SELL,
    ("ops.sell.PreparedSell", "kind"): "picks the SELL or the Pallas chunk layout on the TPU",
    ("ops.sell.PreparedSell", "meta"): "the Pallas chunk layout's tile metadata",
    ("ops.sell.PreparedSell", "src"): "a host copy for the TPU compiler's fallback to chunks",
    ("ops.sell.PreparedSell", "nnz"): "the port reads nnz off the sides it is given",
    ("ops.sell.prepare_sell", "lane"): SELL,
    ("ops.sell.prepare_sell", "bd"): "the Pallas chunk kernels' document tile",
    ("ops.sell.prepare_sell", "bw"): "the Pallas chunk kernels' word tile",
    ("ops.sell.prepare_sell", "build_tables"): "the gather tables of XLA's SELL segment sums",
    ("ops.sell.em_step_sell", "dev"): SELL_DEV,
    ("ops.sell.refit_step_sell", "dev"): SELL_DEV,
    ("ops.sell.log_likelihood_sell", "dev"): SELL_DEV,
    ("ops.sell.em_step_sell", "segsum"): SEGSUM,
    ("ops.sell.refit_step_sell", "segsum"): SEGSUM,
    ("ops.sell.sell_fit", "segsum"): SEGSUM,
    ("ops.sell.sell_refit", "segsum"): SEGSUM,
    ("ops.driver.prepare_counts", "stage"):
        "ships a sparse corpus as COO or dense bytes to the TPU; the port always ships COO",
    ("ops.driver.prepare_counts", "row_bucket"):
        "pads rows to buckets that share TPU compiled programs; the port compiles nothing",
    ("ops.data.pad_dense_counts", "min_rows"): "the row target of the TPU's row buckets",
    ("parallel.mesh.build_sharded_fit", "inner"): INNER,
    ("parallel.mesh.build_sharded_fit", "weighted"):
        "picks a weighted or unweighted compiled program; the port's step takes the weights",
    ("parallel.mesh.mesh_layout_multiples", "inner"): INNER,
    ("parallel.mesh.stage_sharded_counts", "inner"): INNER,
    ("parallel.mesh.stage_sharded_counts", "row_bucket"):
        "pads rows to buckets that share TPU compiled programs; the port compiles nothing",
    ("parallel.sparse_mesh.build_sharded_sparse_fit", "local_docs"):
        "a static shape of the compiled TPU program; the port reads it off the shards",
    ("parallel.sparse_mesh.build_sharded_sparse_fit", "m"):
        "a static shape of the compiled TPU program; the port reads it off the shards",
    ("parallel.sparse_mesh.shard_sell", "lane"): SELL,
    "models.base.TopicModelBase.set_output":
        "scikit-learn offers it only with get_feature_names_out, which neither package has",
}

# what the port has that the JAX package lacks, and why
PLAIN = "the plain PyTorch version of a kernel, which the kernel's tests and the CPU run"
PORT_ONLY = {
    "LAUNCHES": "the kernels' launch counts, which chip_smoke.py reads",
    "models.base.NotFittedError": "scikit-learn's NotFittedError, without scikit-learn",
    "models.base.check_array": "scikit-learn's check_array rules, without scikit-learn",
    "models.base.check_counts": "check_array as a csr_matrix, the estimators' input check",
    "models.base.TopicModelBase.from_state": "load's constructor, shared with the mesh",
    "models.ensemble.bootstrap_inputs": "the ensemble's bootstrap draws, shared by its fits",
    ("models.ensemble.ensemble_fit", "devices"): "the devices of the runs-sharded mesh",
    ("models.ensemble.resolve_parallelism", "devices"): "the devices of the runs-sharded mesh",
    "utils.check_random_state": "scikit-learn's check_random_state, without scikit-learn",
    "cluster.hdbscan.euclidean_distances": "scikit-learn's euclidean_distances, without it",
    "cluster.distances.full_fp32_matmul": "a matmul with TF32 off, as the TPU's HIGHEST",
    "cluster.distances.stack_device": "the device a stack of topics is on or goes to",
    "ops.data.resolve_device": "the torch.device of a device= argument",
    "ops.driver.resolve_device": "the torch.device of a device= argument",
    "ops.data.ship_coo": "ships a corpus to the card as COO, where it is made dense",
    "profiling.Request": "the spans of one request inside the program",
    "profiling.request": "opens a request: a root span with its own id",
    "profiling.span": "opens a span inside the innermost open one",
    "profiling.count": "adds to a counter of the innermost open span",
    "profiling.is_open": "whether a request is open, so that a fit joins it",
    "profiling.idle_by_span": "a trace's device idle time put down to the program's spans",
    ("ops.driver.PreparedCounts", "word"): "the CSC word side that the dense step's A pass walks",
    "ops.driver.kernel_steps": "the EM steps on the CUDA kernels",
    "ops.driver.plain_steps": "the EM steps in plain PyTorch",
    "ops.driver.fit_padded": "the fit on a padded corpus, shared with the mesh",
    "ops.driver.fit_padded_runs": "the ensemble's runs in groups on the batched kernel",
    "ops.driver.refit_padded": "the refit on a padded corpus, shared with the mesh",
    "ops.coo.em_step_coo": "one EM step on COO, the plain version of the reference's loop",
    "ops.em.batched_accumulators_dense": PLAIN,
    "ops.em.em_accumulators_bf16r": PLAIN,
    "ops.em.em_accumulators_ratio": PLAIN,
    "ops.em.em_step_bf16r": PLAIN,
    "ops.em.ratio": PLAIN,
    "ops.em.refit_accumulators_bf16r": PLAIN,
    "ops.em.refit_accumulators_dense": PLAIN,
    "ops.em.refit_step_bf16r": PLAIN,
    "ops.nmf.nmf_cd": "scikit-learn's coordinate-descent NMF, without scikit-learn",
    "ops.sell.word_side": "the CSC word side alone, which the dense step's A pass walks",
    ("ops.sell.PreparedSell", "doc"): "the CSR side the doc pass walks",
    ("ops.sell.PreparedSell", "word"): "the CSC side the word pass walks",
    ("ops.sell.em_step_sell", "prep"): "the PreparedSell, in the place of JAX's dev",
    ("ops.sell.refit_step_sell", "prep"): "the PreparedSell, in the place of JAX's dev",
    ("ops.sell.log_likelihood_sell", "prep"): "the PreparedSell, in the place of JAX's dev",
    "ops.init.randomized_svd": "scikit-learn's randomized_svd (nndsvd's), without scikit-learn",
    "parallel.mesh.Mesh": "jax.sharding.Mesh's part here: the mesh's devices, shape and ranks",
    "parallel.mesh.build_ensemble_runs_sharded": "the runs-sharded ensemble on the port's mesh",
    "parallel.mesh.build_sharded_em_step": "one step of the mesh, a part of build_sharded_fit",
    "parallel.mesh.build_sharded_ll": "the mesh's LL, a part of build_sharded_fit",
    "parallel.mesh.build_sharded_refit_step": "the mesh's refit step",
    "parallel.mesh.gather_cols": "jax.Array's gather of a sharded axis, on torch tensors",
    "parallel.mesh.gather_rows": "jax.Array's gather of a sharded axis, on torch tensors",
    "parallel.mesh.psum": "jax.lax.psum on torch tensors: a sum over tiles or ranks",
    "parallel.mesh.largest_divisor": "the mesh shape the port picks for a device count",
    "parallel.mesh.local_devices": "the devices this process lays tiles on",
    "parallel.mesh.process_ranks": "the torch.distributed ranks a mesh spans",
    ("parallel.mesh.make_mesh", "span_ranks"): "lays the mesh over torch.distributed ranks",
    ("parallel.sparse_mesh.make_docs_mesh", "span_ranks"):
        "lays the mesh over torch.distributed ranks",
    "synthetic.sparse_corpus": "the JAX package's sparse benchmark corpus, in numpy",
}


def _module(package, name):
    return importlib.import_module(f"{package}.{name}" if name else package)


def _home(obj):
    """Where ``obj`` is defined, relative to its package: ``ops.sell.pack_sell``."""
    module = obj.__module__.partition(".")[2]
    return f"{module}.{obj.__qualname__}" if module else obj.__qualname__


def _is_api(obj):
    return inspect.isclass(obj) or inspect.isfunction(obj)


def _of_jax(obj):
    return _is_api(obj) and obj.__module__.partition(".")[0] == JAX


def _surface(module):
    """``{name: object}``: what ``module`` defines and what its ``__all__`` exports."""
    names = set(getattr(module, "__all__", ()))
    names.update(name for name, obj in vars(module).items()
                 if not name.startswith("_") and _is_api(obj)
                 and obj.__module__ == module.__name__)
    return {name: getattr(module, name) for name in sorted(names)}


def _methods(cls):
    """The public methods of ``cls`` (``__sklearn_tags__`` counts as public)."""
    return sorted(name for name in dir(cls)
                  if (not name.startswith("_") or name == "__sklearn_tags__")
                  and callable(getattr(cls, name, None)) and not inspect.isclass(
                      getattr(cls, name)))


def _owner(cls, method, package):
    """The name of ``method`` on the highest class of ``package`` in ``cls``'s
    MRO that has it: ``models.base.TopicModelBase.set_output``."""
    owners = [c for c in cls.__mro__ if c.__module__.partition(".")[0] == package
              and hasattr(c, method)]
    return f"{_home(owners[-1])}.{method}"


def _parameters(fn):
    return list(inspect.signature(fn).parameters.values())


def _compare_signatures(key, ref_fn, port_fn):
    """``(gaps, extras, faults)`` of the port's parameters against JAX's:
    JAX parameters the port lacks, port parameters JAX lacks (``device``
    aside), and any other disagreement: the order, a kind, or ``device``
    before one of JAX's parameters."""
    ref, port = _parameters(ref_fn), _parameters(port_fn)
    ref_names, port_names = [p.name for p in ref], [p.name for p in port]
    gaps = [(key, name) for name in ref_names if name not in port_names]
    extras = [(key, name) for name in port_names
              if name not in ref_names and name != "device"]
    shared = [p for p in port if p.name in ref_names]
    kept = [p for p in ref if p.name in port_names]
    faults = []
    if [p.name for p in shared] != [p.name for p in kept]:
        faults.append(f"{key}: parameters in another order than JAX's, "
                      f"{[p.name for p in shared]} vs {[p.name for p in kept]}")
    faults += [f"{key}: {a.name} is {b.kind.description}, JAX's {a.kind.description}"
               for a, b in zip(kept, shared) if a.name == b.name and a.kind != b.kind]
    if "device" in port_names and "device" not in ref_names and kept and (
            port_names.index("device") < port_names.index(kept[-1].name)):
        faults.append(f"{key}: device comes before JAX's parameter {kept[-1].name}")
    return gaps, extras, faults


def _default_instance(cls):
    """``cls()``, or None where the class needs arguments."""
    try:
        return cls()
    except TypeError:
        return None


def _compare_classes(ref_cls, port_cls):
    gaps, extras, faults = _compare_signatures(_home(ref_cls), ref_cls.__init__,
                                               port_cls.__init__)
    ref_methods, port_methods = _methods(ref_cls), _methods(port_cls)
    for method in ref_methods:
        key = _owner(ref_cls, method, JAX)
        if method not in port_methods:
            gaps.append(key)
            continue
        found = _compare_signatures(key, getattr(ref_cls, method), getattr(port_cls, method))
        gaps += found[0]
        extras += found[1]
        faults += found[2]
    extras += [_owner(port_cls, method, PORT) for method in port_methods
               if method not in ref_methods]
    ref_instance = _default_instance(ref_cls)
    if ref_instance is not None:
        port_instance = port_cls()
        faults += [f"{_home(ref_cls)}.{method}: on JAX's instances, not on the port's"
                   for method in ref_methods
                   if method in port_methods and hasattr(ref_instance, method)
                   and not hasattr(port_instance, method)]
    return gaps, extras, faults


@functools.cache
def _differences(name):
    """``(gaps, extras, faults)`` between the packages' module ``name``: what
    the port lacks, what JAX lacks, and what no entry can excuse."""
    ref, port = _module(JAX, name), _module(PORT, name)
    prefix = f"{name}." if name else ""
    gaps, extras, faults = [], [], []
    for attr, obj in _surface(ref).items():
        counterpart = getattr(port, attr, None)
        if not hasattr(port, attr) or (_is_api(obj) and not _is_api(counterpart)):
            gaps.append(prefix + attr)
            continue
        if not _is_api(obj):
            continue
        if inspect.isclass(obj) != inspect.isclass(counterpart):
            faults.append(f"{prefix}{attr}: a class in one package, a function in the other")
            continue
        compare = _compare_classes if inspect.isclass(obj) else functools.partial(
            _compare_signatures, _home(obj))
        found = compare(obj, counterpart)
        gaps += found[0]
        extras += found[1]
        faults += found[2]
    extras += [prefix + attr for attr, obj in _surface(port).items()
               if not hasattr(ref, attr) or (_is_api(obj) and not _of_jax(getattr(ref, attr)))]
    return sorted(set(gaps), key=str), sorted(set(extras), key=str), faults


@pytest.mark.parametrize("name", MODULES, ids=lambda name: name or "enstop")
def test_port_has_the_jax_surface(name):
    gaps, _, faults = _differences(name)
    assert not faults, "\n".join(faults)
    unlisted = [gap for gap in gaps if gap not in EXCEPTIONS]
    assert not unlisted, f"JAX's, not in the port and not in EXCEPTIONS: {unlisted}"


@pytest.mark.parametrize("name", MODULES, ids=lambda name: name or "enstop")
def test_port_extras_are_listed(name):
    extras = _differences(name)[1]
    unlisted = [extra for extra in extras if extra not in PORT_ONLY]
    assert not unlisted, f"the port's, not JAX's and not in PORT_ONLY: {unlisted}"


@pytest.mark.parametrize("table", ["EXCEPTIONS", "PORT_ONLY"])
def test_every_entry_has_a_reason(table):
    for key, reason in globals()[table].items():
        assert isinstance(key, str) or (
            isinstance(key, tuple) and len(key) == 2 and all(isinstance(k, str) for k in key)
        ), key
        assert isinstance(reason, str) and reason.strip() and "\n" not in reason, key


@pytest.mark.parametrize("table", ["EXCEPTIONS", "PORT_ONLY"])
def test_no_dead_entries(table):
    """Each entry names a difference the walk finds, so none outlives it."""
    found = {key for name in MODULES
             for key in _differences(name)[0 if table == "EXCEPTIONS" else 1]}
    dead = sorted(set(globals()[table]) - found, key=str)
    assert not dead, f"{table} entries that name no difference: {dead}"

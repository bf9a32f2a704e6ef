"""``DistributedPLSA`` across the ranks of a ``torch.distributed`` process
group: two processes on the CPU (``gloo``), each given the whole corpus, each
fitting its own docs shard. Both ranks must return what one process fits on a
2-shard mesh, to rtol 1e-6 (the same sums: a rank's partial, then the
all-reduce of two). The processes are joined under a hard timeout, so a hang
fails the test rather than stalling the suite. This file imports no JAX: the
ranks import it afresh.
"""

import multiprocessing
import queue
import socket
import time
import traceback

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import enstop_torch

TIMEOUT_S = 120
RTOL = 1e-6
LAYOUTS = ("dense", "sparse")


def _corpus():
    rng = np.random.RandomState(11)
    X = sp.csr_matrix(rng.poisson(0.6, (57, 83)).astype(np.int64))
    w = rng.uniform(0.5, 1.5, X.shape[0]).astype(np.float32)
    return X, w


def _fits(model_cls):
    """Each layout's fitted factors, history and transform."""
    X, w = _corpus()
    out = {}
    for layout in LAYOUTS:
        model = model_cls(n_components=3, n_iter=15, n_iter_per_test=5, random_state=0,
                          layout=layout, device="cpu")
        model.fit(X, sample_weight=w)
        out[layout] = {"components_": model.components_, "embedding_": model.embedding_,
                       "history_": model.history_, "n_iter_": model.n_iter_,
                       "transform": model.transform(X[:13])}
    return out


def _rank_main(rank, port, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank)
        try:
            out = _fits(enstop_torch.DistributedPLSA)
            try:
                enstop_torch.DistributedPLSA(n_col_blocks=2, device="cpu").fit(_corpus()[0])
                out["n_col_blocks=2"] = "ran"
            except ValueError as err:
                out["n_col_blocks=2"] = str(err)
        finally:
            dist.destroy_process_group()
        results.put((rank, out))
    except Exception:
        results.put((rank, traceback.format_exc()))


class _TwoShards(enstop_torch.DistributedPLSA):
    def _devices(self):
        return [torch.device("cpu")] * 2


def test_two_ranks_match_one_process_on_two_shards():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(rank, port, results), daemon=True)
             for rank in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    got = {}
    try:
        for _ in procs:  # drain the queue before joining
            rank, out = results.get(timeout=max(deadline - time.monotonic(), 1))
            got[rank] = out
    except queue.Empty:
        pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1))
            if p.is_alive():
                p.kill()
                p.join()
    for rank, out in got.items():
        assert isinstance(out, dict), f"rank {rank} failed:\n{out}"
    assert not any(p.is_alive() for p in procs)

    want = _fits(_TwoShards)
    for rank in (0, 1):
        assert "docs axis" in got[rank]["n_col_blocks=2"]
        for layout in LAYOUTS:
            mine, ref = got[rank][layout], want[layout]
            assert mine["n_iter_"] == ref["n_iter_"]
            for name in ("components_", "embedding_", "history_", "transform"):
                np.testing.assert_allclose(mine[name], ref[name], rtol=RTOL, atol=0,
                                           err_msg=f"rank {rank} {layout} {name}")

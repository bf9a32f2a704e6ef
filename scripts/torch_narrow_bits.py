"""The bits of every kernel instance up to 256 topics, on one NVIDIA GPU: a
SHA-256 digest of each output of the sparse passes (``em_sparse.cu``: every
walk shape of ``cuda_sparse.WALK_SHAPES`` at both chunk widths, every mode:
plain, thresholded and bf16r word pass, plain and thresholded doc pass, the
ratio modes of the divide experiment, the LL on), of the dense EM step, its
refit and LL sweep at both precisions (``em_dense.cu``) and of the batched
step (``em_batch.cu``), on the main paths' inputs: the JAX package's sparse
config C (250,000 x 141,000, 19 M Zipf draws) and the 20-Newsgroups shape,
with factors drawn from a fixed seed.

    PYTHONPATH=. python3 scripts/torch_narrow_bits.py [--root CHECKOUT] --out FILE [--against FILE]

``--root`` names the checkout whose ``enstop_torch`` computes the digests
(this one by default), so that one call on the card can take a parent's and
a change's: run it on the parent's checkout, then on the change's with
``--against`` the parent's file. Digests compare only within one card and
toolchain. Prints the card's name and power limit and writes ``{"card",
"torch", "cuda", "digests": {instance: hex}}`` to ``--out``; with
``--against``, prints the instances whose digests differ and exits 1 if any
does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CONFIG_C = (250_000, 141_000, 19_000_000)
# a kp at each walk shape's widest, and one of its kp % 4 != 0 (scalar chunks)
SPARSE_KPS = (3, 4, 7, 8, 13, 16, 20, 30, 32, 63, 64, 104, 127, 128, 255, 256)
EXPERIMENT_KPS = (19, 20)  # the ratio modes 1-5: the word pass at (L, TPL) = (4, 8)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def factors(n, m, kp, seed, device):
    """Rows of ``P(z|d)`` (n, kp) and columns of ``P(w|z)^T`` (m, kp)
    normalised, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    zd = rng.random((n, kp), dtype=np.float32) + 0.01
    zd /= zd.sum(1, keepdims=True)
    wzT = rng.random((m, kp), dtype=np.float32) ** 4 + 1e-4
    wzT /= wzT.sum(0, keepdims=True)
    return torch.from_numpy(zd).to(device), torch.from_numpy(wzT).to(device)


def narrow_bits(device="cuda"):
    """``{instance: digest}`` of every kernel instance up to 256 topics."""
    import enstop_torch
    from enstop_torch.ops import cuda_batch, cuda_em, cuda_sparse
    from enstop_torch.synthetic import sparse_corpus, twenty_newsgroups_shape

    out = {}
    X = sparse_corpus(*CONFIG_C, seed=0).astype(np.int64)
    prep = enstop_torch.prepare_sell(X, standardize=False, device=device)
    w = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 1.5, prep.n)
                         .astype(np.float32)).to(device)
    modes = {"word": (True, None, "f32div"), "word_thresh": (True, 1e-16, "f32div"),
             "word_bf16r": (True, None, "bf16r"), "doc": (False, None, "f32div"),
             "doc_thresh": (False, 1e-16, "f32div")}
    for kp in SPARSE_KPS:
        zd, wzT = factors(prep.n, prep.m, kp, kp, device)
        for name, (word, thresh, ratio) in modes.items():
            side = prep.word if word else prep.doc
            res = cuda_sparse._pass(side, zd, wzT, w, word, thresh, True, ratio)
            out[f"config C kp {kp} {name}"] = digest(*res)
    for kp in EXPERIMENT_KPS:
        zd, wzT = factors(prep.n, prep.m, kp, kp, device)
        for ratio in cuda_em.RATIO_MODES[1:-1]:
            res = cuda_sparse._pass(prep.word, zd, wzT, w, True, None, True, ratio)
            out[f"config C kp {kp} word_{ratio}"] = digest(*res)
    del prep, zd, wzT, w
    X, _ = twenty_newsgroups_shape(seed=0)
    dense = enstop_torch.prepare_counts(X, device=device)
    Xd = dense.device_array
    n_pad, m_pad = Xd.shape
    zd, wzT = factors(n_pad, m_pad, 24, 24, device)
    wz = wzT.t().contiguous()
    w = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 1.5, n_pad)
                         .astype(np.float32)).to(device)
    for precision in ("default", "fast"):
        out[f"20NG kp 24 em {precision}"] = digest(*cuda_em.em_step_fused(
            Xd, zd, wz, w, compute_ll=True, precision=precision, word=dense.word))
        out[f"20NG kp 24 refit {precision}"] = digest(*cuda_em.refit_step_fused(
            Xd, zd, wz, w, compute_ll=True, precision=precision))
        out[f"20NG kp 24 ll {precision}"] = digest(cuda_em.log_likelihood_fused(
            Xd, zd, wz, w, precision=precision))
    for ratio in cuda_em.RATIO_MODES[1:-1]:
        out[f"20NG kp 24 em {ratio}"] = digest(*cuda_em._em_accumulators_ratio(
            Xd, zd, wz, w, ratio, word=dense.word)[:2])
    R = 4
    zds = torch.stack([factors(n_pad, m_pad, 24, 30 + r, device)[0] for r in range(R)])
    wzs = torch.stack([factors(n_pad, m_pad, 24, 40 + r, device)[1].t().contiguous()
                       for r in range(R)])
    ws = w.expand(R, n_pad).contiguous()
    out["20NG kp 24 batch R 4"] = digest(*cuda_batch.batched_accumulators(
        Xd, zds, wzs, ws, word=dense.word))
    torch.cuda.synchronize()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--out", required=True)
    parser.add_argument("--against", help="digests of another checkout, to compare with")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import enstop_torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, "enstop_torch from", Path(enstop_torch.__file__).parent, flush=True)
    from enstop_torch.ops import _build

    _build.build_all()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "digests": narrow_bits()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(len(result["digests"]), "digests written to", args.out)
    if args.against:
        other = json.loads(Path(args.against).read_text())["digests"]
        differ = sorted(key for key in set(other) | set(result["digests"])
                        if other.get(key) != result["digests"].get(key))
        print(f"against {args.against}: {len(other) - len(differ)} of {len(other)} the same"
              + (f"; differ: {', '.join(differ)}" if differ else ""))
        if differ:
            raise SystemExit(1)


if __name__ == "__main__":
    main()

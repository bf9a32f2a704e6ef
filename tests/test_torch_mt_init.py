"""The random init drawn on the card (``ops/csrc/mt_uniform.cu``) as a plain
NumPy model, held bit for bit to the host's draws on the CPU.

The model computes what the two kernels compute: ``mt_twist``'s MT19937, the
words left in the key first and then a twist whenever pos is 624 and another
word is needed, each twist in its three phases (words 0-226 from the old
key, 227-453 from new words 0-226, 454-623 from new words 227-396 with the
new word 0 as the last word's neighbour), tempered; and ``uniform_rows``'s
legacy doubles from word pairs, each row summed in pieces of
``ops.init._row_sum_piece()`` values, each piece by numpy's pairwise sum,
each value divided by the sum in float64 (by 1.0 where a guarded sum is 0)
and rounded to float32, a chunk of whole rows at a time. It is held to
``plsa_init(init="random")`` and ``driver._refit_init`` and its end state
(key, pos, the cached Gaussian) to numpy's, at topic counts 1 to 1,000, rows
that cross twist boundaries and rows longer than numpy's buffer, from a
fresh state, one part used (pos odd), one holding a cached Gaussian, and a
draw that ends on a twist boundary. The rule that sends a draw to the card
keeps ``RandomState(PCG64())``, CPU devices and small draws on the host.
The kernels themselves are held to the host on the card in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from enstop_torch.ops import init as init_ops
from enstop_torch.ops.driver import _refit_init
from enstop_torch.ops.init import CHUNK_WORDS, DEVICE_DRAW_MIN, plsa_init

N, M, HALF = 624, 397, 227
UPPER, LOWER, MATRIX_A = np.uint32(0x80000000), np.uint32(0x7FFFFFFF), np.uint32(0x9908B0DF)


def _mix(cur, nxt):
    y = (cur & UPPER) | (nxt & LOWER)
    return (y >> np.uint32(1)) ^ np.where(y & np.uint32(1), MATRIX_A, np.uint32(0))


def _twist(cur):
    """The next key, in the kernel's three phases."""
    nxt = np.empty_like(cur)
    nxt[:HALF] = cur[M:] ^ _mix(cur[:HALF], cur[1:HALF + 1])
    nxt[HALF:2 * HALF] = nxt[:HALF] ^ _mix(cur[HALF:2 * HALF], cur[HALF + 1:2 * HALF + 1])
    neighbours = np.concatenate([cur[2 * HALF + 1:], nxt[:1]])
    nxt[2 * HALF:] = nxt[HALF:N - HALF] ^ _mix(cur[2 * HALF:], neighbours)
    return nxt


def _temper(y):
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    return y ^ (y >> np.uint32(18))


def _words(key, pos, n):
    """mt_twist: n tempered words and the (key, pos) it leaves."""
    out = np.empty(n, np.uint32)
    done = min(N - pos, n)
    out[:done] = _temper(key[pos:pos + done])
    pos += done
    while done < n:
        key = _twist(key)
        take = min(N, n - done)
        out[done:done + take] = _temper(key[:take])
        done += take
        pos = take
    return out, key, pos


def _pairwise(v):
    """numpy's DOUBLE_pairwise_sum of the float64 values v, in Python floats."""
    n = len(v)
    if n < 8:
        res = 0.0
        for x in v:
            res += float(x)
        return res
    if n <= 128:
        r = [float(x) for x in v[:8]]
        i = 8
        while i < n - n % 8:
            r = [r[j] + float(v[i + j]) for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for x in v[i:]:
            res += float(x)
        return res
    h = n // 2 - n // 2 % 8
    return _pairwise(v[:h]) + _pairwise(v[h:])


def _row(words, piece, guard):
    """uniform_rows for one row's words."""
    a = (words[0::2] >> np.uint32(5)).astype(np.float64)
    b = (words[1::2] >> np.uint32(6)).astype(np.float64)
    v = (a * 67108864.0 + b) / 9007199254740992.0
    piece = piece or len(v)
    acc = 0.0
    for off in range(0, len(v), piece):
        acc += _pairwise(v[off:off + piece])
    d = 1.0 if guard and not acc > 0.0 else acc
    return (v / d).astype(np.float32)


def _model(state, shapes, guard):
    """Each (rows, len) of ``shapes`` drawn in turn from the numpy state
    dict ``state``, a chunk of whole rows at a time as ``_uniform_rows``
    launches them; returns the arrays and the state left."""
    key = state["state"]["key"].astype(np.uint32)
    pos = int(state["state"]["pos"])
    piece = init_ops._row_sum_piece()
    outs = []
    for rows, length in shapes:
        out = np.empty((rows, length), np.float32)
        per = max(1, CHUNK_WORDS // (2 * length))
        for r0 in range(0, rows, per):
            r = min(per, rows - r0)
            words, key, pos = _words(key, pos, 2 * r * length)
            for i in range(r):
                out[r0 + i] = _row(words[2 * i * length:2 * (i + 1) * length], piece, guard)
        outs.append(out)
    return outs, {"bit_generator": "MT19937", "state": {"key": key, "pos": pos},
                  "has_gauss": state["has_gauss"], "gauss": state["gauss"]}


def _same_state(a, b):
    assert a["bit_generator"] == b["bit_generator"] == "MT19937"
    assert np.array_equal(a["state"]["key"].astype(np.uint32),
                          b["state"]["key"].astype(np.uint32))
    assert int(a["state"]["pos"]) == int(b["state"]["pos"])
    assert a["has_gauss"] == b["has_gauss"] and a["gauss"] == b["gauss"]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _rng(seed, before):
    rng = np.random.RandomState(seed)
    if before == "odd":
        rng.randint(0, 1000, size=3)
        assert rng.get_state()[2] % 2 == 1, "an odd number of words used"
    elif before == "gauss":
        rng.standard_normal(3)
        assert rng.get_state()[3] == 1, "a cached Gaussian"
    return rng


# (k, n, m, seed, state before the draw)
CASES = [(k, n, m, seed, None)
         for k, n, m in [(1, 97, 20_011), (7, 301, 613), (8, 129, 1_000), (20, 250, 317),
                         (129, 33, 2_500), (1_000, 41, 150)]
         for seed in (0, 2**32 - 1)]
CASES += [(20, 250, 317, 3, "odd"), (8, 129, 1_000, 4, "gauss"),
          (1, 112, 200, 5, None)]  # 2 (112 + 200) words: one twist, ending on its boundary


@pytest.mark.parametrize("k,n,m,seed,before", CASES)
def test_the_kernels_model_is_the_host_draw(k, n, m, seed, before):
    assert init_ops._row_sum_piece() is not None, "numpy's row sums in a known order"
    rng = _rng(seed, before)
    start = rng.get_state(legacy=False)
    zd, wz = plsa_init(sp.csr_matrix((n, m)), k, init="random", rng=rng)
    (model_wz, model_zd), left = _model(start, [(k, m), (n, k)], guard=True)
    assert np.array_equal(_bits(model_wz), _bits(wz))
    assert np.array_equal(_bits(model_zd), _bits(zd))
    _same_state(left, rng.get_state(legacy=False))
    if (seed, before) == (5, None):
        assert int(left["state"]["pos"]) == N  # the draw ended on the boundary, untwisted

    refit = _refit_init(rng, n, k)
    (model_refit,), left = _model(left, [(n, k)], guard=False)
    assert np.array_equal(_bits(model_refit), _bits(refit))
    _same_state(left, rng.get_state(legacy=False))


def test_the_row_sum_probe_reads_numpys_order():
    x = np.random.RandomState(7).rand(16, 3 * np.getbufsize() + 77)
    assert np.array_equal(init_ops._row_sums(x, init_ops._row_sum_piece()), x.sum(axis=1))
    rows = [np.array([_pairwise(r)]) for r in x[:2]]  # the model's sum over the whole row
    assert np.array_equal(np.concatenate(rows), init_ops._row_sums(x[:2], 0))


@pytest.mark.parametrize("rng,device,n_values,on_card", [
    (np.random.RandomState(0), "cuda", DEVICE_DRAW_MIN, True),
    (np.random.mtrand._rand, "cuda", 10**8, True),
    (np.random.RandomState(np.random.PCG64(0)), "cuda", 10**8, False),
    (np.random.RandomState(0), "cpu", 10**8, False),
    (np.random.RandomState(0), "cuda", DEVICE_DRAW_MIN - 1, False),
])
def test_the_rule_keeps_other_streams_devices_and_small_draws_on_the_host(
        rng, device, n_values, on_card):
    before = rng.get_state(legacy=False)
    assert init_ops._draws_on_device(rng, torch.device(device), n_values) is on_card
    after = rng.get_state(legacy=False)  # the rule draws nothing
    assert before["bit_generator"] == after["bit_generator"]
    for name, value in before["state"].items():
        assert np.array_equal(value, after["state"][name]), name

"""Port vs JAX reference: NII turbo constituent kernel, full turbo decodes
and the turbo encoder (its plain twin on the CPU, and its kernel's launch
on the card's path with the launch recorded, not made).

The JAX side runs the Pallas NII kernel in interpret mode with a tiny
tile (TURBO_SUB=8, TURBO_LANES=1), as the reference's own tests do; the
port side runs the kernel's plain twin on the CPU. Both execute the same
float32 operations in the same order, so the tolerance is the float32
rounding of a handful of adds (rtol = atol = 1e-5). The full decodes run
at float32 (pinned on both sides) and at bfloat16, the precision both
packages' ``dtype="auto"`` gives a windowed NII decode; in bfloat16 every
op rounds to bfloat16 on both sides, and bits, LLRs and the early stop's
iteration count are equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models.sch import DlschPlan as JaxPlan
from empower_srslte_tpu.models.sch import dlsch_encode as jax_dlsch_encode
from empower_srslte_tpu.ops.fec.derm_tiles import parity_rows_interleaved
from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder as JaxTurbo
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas2 import (
    map_decode_nii as jax_map_decode_nii, to_tiles)
from empower_srslte_tpu.ops.fec.turbo_encoder import turbo_encode_np
from empower_srslte_tpu.utils.crc import CRC24B as JAX_CRC24B

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import sch
from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.ops.fec import turbo_encoder as te
from empower_srslte_tpu_torch.ops.fec.tables import (TURBO_CB_SIZES,
                                                     qpp_coefficients)
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
    map_decode_nii, map_decode_nii_plain)
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.crc import CRC24B

from tests.torch_fake_launch import STREAM, fake_launches

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")


def _rows_to_jax(x):
    """port [R, B] -> JAX tiles [T, R, 8, 1]."""
    return jnp.asarray(to_tiles(x, 1, 8))


def _state_to_jax(x):
    """port [W+1, 8, B] -> JAX [T, W+1, 8, 8, 1]."""
    w1, _, b = x.shape
    return jnp.asarray(x.reshape(w1, 8, b // 8, 8, 1).transpose(2, 0, 1, 3, 4))


def _rows_from_jax(x):
    x = np.asarray(x)
    t, r, s, l = x.shape
    return x.transpose(1, 0, 2, 3).reshape(r, t * s * l)


def _state_from_jax(x):
    x = np.asarray(x)
    t, w1, _, s, l = x.shape
    return x.transpose(1, 2, 0, 3, 4).reshape(w1, 8, t * s * l)


@pytest.mark.parametrize("bounds", [None, (-1, -1)])
def test_nii_kernel_plain_twin_matches_pallas(rng, bounds):
    k, l, b = 256, 64, 16
    w = k // l
    f = lambda *s: (2.0 * rng.normal(size=s)).astype(np.float32)
    u, p, apr = f(k, b), f(k, b), f(k, b)
    tu, tp = f(3, b), f(3, b)
    a_st, b_st = f(w + 1, 8, b), f(w + 1, 8, b)

    pad8 = lambda x: np.concatenate([x, np.zeros((5, b), np.float32)])
    jb = None if bounds is None else jnp.asarray(bounds, jnp.int32)
    ext_j, a_j, b_j = jax_map_decode_nii(
        _rows_to_jax(u), _rows_to_jax(p), _rows_to_jax(pad8(tu)),
        _rows_to_jax(pad8(tp)), _state_to_jax(a_st), _state_to_jax(b_st),
        l=l, lanes=1, interpret=True, apr=_rows_to_jax(apr), bounds=jb)

    t = lambda x: torch.as_tensor(x)
    ext, a_n, b_n = map_decode_nii(t(u), t(p), t(tu), t(tp), t(a_st),
                                   t(b_st), l=l, apr=t(apr), bounds=bounds)
    np.testing.assert_allclose(ext.numpy(), _rows_from_jax(ext_j), **TOL)
    np.testing.assert_allclose(a_n.numpy(), _state_from_jax(a_j), **TOL)
    np.testing.assert_allclose(b_n.numpy(), _state_from_jax(b_j), **TOL)


def test_nii_wrapper_is_plain_twin_on_cpu(rng):
    """On a CPU tensor the wrapper runs the plain twin and counts no
    kernel launch."""
    k, l, b = 128, 64, 4
    x = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    args = (x(k, b), x(k, b), x(3, b), x(3, b), x(3, 8, b), x(3, 8, b))
    before = trace.launch_counts()
    got = map_decode_nii(*args, l=l)
    ref = map_decode_nii_plain(*args, l=l)
    assert trace.launch_counts() == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _crc_blocks(rng, k, batch):
    payload = rng.integers(0, 2, size=(batch, k - 24)).astype(np.int8)
    return np.stack([JAX_CRC24B.attach(p) for p in payload])


def _awgn_llr(rng, d, ebn0_db):
    ebn0 = 10 ** (ebn0_db / 10)
    n0 = 1.0 / (ebn0 / 3)
    y = 1 - 2 * d.astype(np.float64) + np.sqrt(n0 / 2) * rng.normal(size=d.shape)
    return (4 / n0 * y).astype(np.float32)


def _jax_nii_decode(llr, k, iterations, dtype="float32"):
    """The JAX NII path (TurboDecoder._decode_nii) with the early-stop
    iteration count surfaced: -> (bits [B, K], natural-order LLRs [B, K]
    as float32, iterations)."""
    import jax

    dec = JaxTurbo(k=k, iterations=iterations, window=_pick_window(k),
                   impl="pallas2_interpret", dtype=dtype)
    sys1, par1, sys2_tail, par2 = dec._split_streams(
        jnp.asarray(llr).astype(dtype))
    tm = lambda x: jnp.moveaxis(x, -1, 0)
    pad8 = lambda x: jnp.pad(x, ((0, 8 - x.shape[0]), (0, 0)))
    tiles = lambda x: to_tiles(x, 1, 8)
    p_int = jnp.asarray(parity_rows_interleaved(JAX_CRC24B.poly, 24, k))

    def crc_check(llr_int):
        bits = (llr_int < 0).astype(jnp.float32)
        snd = jnp.einsum("tksl,kc->tcsl", bits, p_int)
        return jnp.all(jnp.mod(snd, 2.0) == 0.0)

    s1, p1, p2 = tm(sys1), tm(par1), tm(par2)
    run = jax.jit(lambda *a: dec.decode_tiles(*a, crc_check=crc_check,
                                               interpret=True))
    llr_int, n_it = run(tiles(s1[:k]), tiles(p1[:k]), tiles(p2[:k]),
                        tiles(pad8(s1[k:])), tiles(pad8(p1[k:])),
                        tiles(pad8(tm(sys2_tail))), tiles(pad8(p2[k:])))
    from empower_srslte_tpu.ops.fec.tables import qpp_deinterleaver

    llr_nat = _rows_from_jax(llr_int.astype(jnp.float32))[
        qpp_deinterleaver(k)]
    return (llr_nat.T < 0).astype(np.int8), llr_nat.T, int(n_it)


@pytest.mark.parametrize("k,ebn0_db,dtype", [
    pytest.param(512, 1.2, "float32", id="512-1.2"),
    pytest.param(1024, 1.0, "float32", id="1024-1.0"),
    pytest.param(512, 1.2, "bfloat16", id="512-1.2-bfloat16"),
    pytest.param(1024, 1.0, "bfloat16", id="1024-1.0-bfloat16")])
def test_full_decode_matches_jax(rng, k, ebn0_db, dtype):
    """Near the waterfall the early stop iterates. In float32 the bits
    equal JAX's and the sent ones; in bfloat16 (both packages' default
    here) bits, LLRs and the iteration count equal JAX's exactly (its
    bits need not all be the sent ones at this SNR)."""
    u = _crc_blocks(rng, k, 8)
    llr = _awgn_llr(rng, turbo_encode_np(u), ebn0_db)
    bits_j, llr_j, it_j = _jax_nii_decode(llr, k, iterations=6, dtype=dtype)

    dec = TurboDecoder(k=k, iterations=6, window=_pick_window(k),
                       dtype=dtype)
    assert dec.metric_dtype == getattr(torch, dtype)
    its = []
    bits, out = dec.decode(torch.as_tensor(llr), crc=CRC24B, iters_out=its)
    assert out.dtype == getattr(torch, dtype)
    assert its == [it_j]
    assert it_j > 1, "the operating point should exercise the early stop"
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    if dtype == "float32":
        np.testing.assert_array_equal(bits.numpy(), u)
    else:
        np.testing.assert_array_equal(out.float().numpy(), llr_j)


@pytest.mark.parametrize("k", [40, 56])
def test_no_window_decode_matches_jax_full_sweep(rng, k):
    """A K without a turbo window: the port decodes it as one NII window
    of l = K, the JAX package with its XLA full-trellis sweep
    (``_map_decode``). Hard bits must be equal; LLRs agree within 0.1,
    since the two renormalize at different points (every step in the
    JAX sweep, every 16 rows in the NII recursion) in float32."""
    assert _pick_window(k) is None
    u = rng.integers(0, 2, size=(16, k)).astype(np.int8)
    coded = _awgn_llr(rng, turbo_encode_np(u), 0.5)
    noise = (3.0 * rng.normal(size=coded.shape)).astype(np.float32)
    llr = np.concatenate([coded, noise])
    bits_j, llr_j = JaxTurbo(k=k, iterations=4, window=None, impl="xla",
                             dtype="float32").decode(jnp.asarray(llr))
    bits, llr_p = TurboDecoder(k=k, iterations=4, window=None).decode(
        torch.as_tensor(llr))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    np.testing.assert_allclose(llr_p.numpy(), np.asarray(llr_j), rtol=0,
                               atol=0.1)


#: the encoder's input dtypes, each with the leading dims it is tried at
ENC_INPUTS = [(torch.int8, (3,)), (torch.int64, (2, 3)),
              (torch.bool, (2, 1, 2))]


@pytest.mark.parametrize("dtype,lead", ENC_INPUTS,
                         ids=[str(d).removeprefix("torch.")
                              for d, _ in ENC_INPUTS])
# the ends of Table 5.1.3-3, 512 and 1024, and a K of each step class
# (8, 16, 32, 64) beside them, K % 32 of 0, 8, 16 and 24 among them
@pytest.mark.parametrize("k", [40, 120, 512, 784, 1024, 1568, 2112, 5824,
                               6144])
def test_turbo_encoder_matches_numpy(rng, k, dtype, lead):
    u = rng.integers(0, 2, size=(*lead, k)).astype(np.int8)
    got = turbo_encode(torch.as_tensor(u).to(dtype))
    assert got.dtype == torch.int8 and got.shape == (*lead, 3, k + 4)
    np.testing.assert_array_equal(
        got.numpy(), turbo_encode_np(u.reshape(-1, k)).reshape(got.shape))


_M32 = 0xFFFFFFFF


def _rotr7(p, o):
    return ((p >> o) | (p << (7 - o))) & 0x7F


def _rotl7(p, o):
    return ((p << o) | (p >> (7 - o))) & 0x7F


def _kernel_rsc(words: np.ndarray, k: int):
    """csrc/turbo_enc.cu's constituent on packed input words [rows, NW]
    (bit j of word w is input bit 32w + j): the feedback register a as b's
    prefix XOR at stride 7 within a word, plus the 7 classes of every
    earlier word's b (the lanes' scan, here one exclusive XOR scan), the
    parity a ^ a<<1 ^ a<<3 and the final state r1 r2 r3 -> (parity words,
    state)."""
    nw = words.shape[1]
    up = np.concatenate([np.zeros_like(words[:, :1]), words[:, :-1]], 1)
    b = (words ^ (words << 2 | up >> 30) ^ (words << 3 | up >> 29)
         ^ (words << 4 | up >> 28)) & _M32
    x = (b ^ b << 7) & _M32
    x = (x ^ x << 14) & _M32
    x = (x ^ x << 28) & _M32
    o = 4 * np.arange(nw) % 7                       # 32 w mod 7
    q = _rotl7((b ^ b >> 7 ^ b >> 14 ^ b >> 21 ^ b >> 28) & 0x7F, o)
    before = np.bitwise_xor.accumulate(q, axis=1) ^ q
    r = _rotr7(before, o)
    a = x ^ (r * 0x10204081 & _M32)
    par = (a ^ (a << 1 | r >> 6 & 1) ^ (a << 3 | r >> 4 & 7)) & _M32
    j1 = k - 1 - 32 * (nw - 1)
    last = a[:, -1]
    return par, (last >> j1 & 1) << 2 | (last >> j1 - 1 & 1) << 1 \
        | (last >> j1 - 2 & 1)


def _kernel_encode(u: np.ndarray) -> np.ndarray:
    """csrc/turbo_enc.cu's arithmetic in numpy on u [rows, K]: pi stepped
    per lane from f1 and f2, the inputs packed 32 bits a word, both
    constituents (``_kernel_rsc``), the tails' closed forms and d written
    a nibble spread to four bytes at a time."""
    rows, k = u.shape
    nw = -(-k // 32)
    f1, f2 = qpp_coefficients(k)
    lane = np.arange(32)
    pi, g = (f1 * lane + f2 * lane * lane) % k, \
        (32 * f1 + 1024 * f2 + 64 * f2 * lane) % k
    pis = []
    for _ in range(nw):
        pis.append(pi)
        pi, g = pi + g, g + 2048 * f2 % k
        pi, g = pi - k * (pi >= k), g - k * (g >= k)
    pis = np.concatenate(pis)
    valid = np.arange(32 * nw) < k
    bits = np.arange(32, dtype=np.int64)

    def pack(x):
        return (x.astype(np.int64).reshape(rows, nw, 32) << bits).sum(-1)

    nat = pack(np.where(valid, np.pad(u, ((0, 0), (0, 32 * nw - k))), 0))
    par1, s1 = _kernel_rsc(nat, k)
    par2, s2 = _kernel_rsc(pack(np.where(valid, u[:, pis], 0)), k)

    def tail(s):
        r1, r2, r3 = s >> 2 & 1, s >> 1 & 1, s & 1
        return (np.stack([r2 ^ r3, r1 ^ r2, r1]),     # x_K..x_K+2
                np.stack([r1 ^ r3, r2, r1]))          # z_K..z_K+2
    (x1, z1), (x2, z2) = tail(s1), tail(s2)
    tails = [[x1[0], z1[1], x2[0], z2[1]], [z1[0], x1[2], z2[0], x2[2]],
             [x1[1], z1[2], x2[1], z2[2]]]
    d = np.empty((rows, 3, (k + 4) // 4), np.int64)
    for stream, src in enumerate((nat, par1, par2)):
        nib = src[:, np.arange(k // 4) >> 3] >> 4 * (np.arange(k // 4) & 7) \
            & 0xF
        t = sum(bit << j for j, bit in enumerate(tails[stream]))
        d[:, stream] = np.concatenate([nib, t[:, None]], 1)
    spread = (d * 0x00204081 & 0x01010101).astype("<u4")
    return spread.view(np.int8).reshape(rows, 3, k + 4)


@pytest.mark.parametrize("step", [8, 16, 32, 64])
def test_kernel_arithmetic_reproduces_the_twin(rng, step):
    """The kernel's word arithmetic, in numpy, equals the twin bit for bit
    at every K of one step class of Table 5.1.3-3 (all 188 over the four
    cases), on random code blocks, all ones and all zeros."""
    sizes = [k for i, k in enumerate(TURBO_CB_SIZES)
             if (TURBO_CB_SIZES[i + 1] if i + 1 < len(TURBO_CB_SIZES)
                 else k + 64) - k == step]
    assert len(sizes) == {8: 59, 16: 32, 32: 32, 64: 65}[step]
    for k in sizes:
        u = rng.integers(0, 2, size=(3, k)).astype(np.int8)
        u[1], u[2] = 1, 0
        np.testing.assert_array_equal(
            _kernel_encode(u), te._turbo_encode_plain(torch.as_tensor(u))
            .numpy(), err_msg=f"K={k}")


@pytest.mark.parametrize("k", [44, 520, 6208])
def test_turbo_encoder_refuses_a_k_off_the_table(monkeypatch, k):
    """K % 8 != 0, a multiple of 8 between two sizes of the table, and one
    past its end: refused on either path, and nothing launched."""
    for on_card in (False, True):
        monkeypatch.setattr(te, "_on_card", lambda t, c=on_card: c)
        launched = fake_launches(monkeypatch, te.TURBO_ENC)
        with pytest.raises(ValueError, match="not a valid turbo CB size"):
            turbo_encode(torch.zeros((2, k), dtype=torch.int8))
        assert launched == []


def test_turbo_encoder_launches_once_on_the_card(monkeypatch):
    """On the card's path (the launches recorded, not made): one launch a
    call over every row of the leading dims, contiguous int8 bits passed
    as they are, other dtypes and an unaligned view as an aligned int8
    copy, d allocated as ``turbo_encode`` returns it, each launch counted
    under (K, rows); no launch for no rows."""
    k = 5824
    f1, f2 = qpp_coefficients(k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        te.turbo_encode_cuda(torch.zeros((1, k), dtype=torch.int8))
    monkeypatch.setattr(te, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, te.TURBO_ENC)
    flat = torch.zeros(1 + 3 * k, dtype=torch.int8)
    inputs = {"int8": torch.zeros((2, 3, k), dtype=torch.int8),
              "int64": torch.zeros((2, 3, k), dtype=torch.int64),
              "unaligned": flat[1:].view(3, k)}
    trace.reset()
    try:
        outs = {name: turbo_encode(u) for name, u in inputs.items()}
        empty = turbo_encode(torch.zeros((0, k), dtype=torch.int8))
        counts = trace.launch_counts()
        shapes = trace.launch_shapes("turbo_enc")
    finally:
        trace.reset()
    assert counts == {"turbo_enc": 3} and len(launched) == 3
    assert shapes == {(k, 6): 2, (k, 3): 1}
    assert empty.shape == (0, 3, k + 4)
    for (name, _dev, args), (tag, u) in zip(launched, inputs.items()):
        ptr, d, rows, kk, a, b, stream = args
        assert name == "turbo_enc" and stream == STREAM
        assert (rows, kk, a, b) == (u[..., 0].numel(), k, f1, f2)
        assert d == outs[tag].data_ptr() and outs[tag].dtype == torch.int8
        assert outs[tag].shape == (*u.shape[:-1], 3, k + 4)
        assert ptr % 8 == 0 and (ptr == u.data_ptr()) == (tag == "int8")


def test_dlsch_encode_launches_once_a_k_inside_turbo_encode(monkeypatch):
    """On the card's path (the launch recorded, not made), ``dlsch_encode``
    on a TB of K- and K+ blocks launches the kernel once for each K, over
    every code block of that K, inside the range ``dlsch.turbo_encode``
    and no other."""
    import contextlib

    plan = sch.DlschPlan(tbs=15000, g=45000, qm=6, rv=2)
    assert len(plan.k_groups) == 2
    open_spans: list = []

    @contextlib.contextmanager
    def span(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()

    monkeypatch.setattr(sch.trace, "span", span)
    monkeypatch.setattr(te, "_on_card", lambda t: True)
    fake_launches(monkeypatch, te.TURBO_ENC)
    inside = []
    monkeypatch.setattr(te.TURBO_ENC, "_fn",
                        lambda *a: inside.append((list(open_spans), a)) or 0)
    trace.reset()
    try:
        sch.dlsch_encode(torch.zeros((2, plan.tbs), dtype=torch.int8), plan)
        counts = trace.launch_counts()
    finally:
        trace.reset()
    assert counts == {"turbo_enc": 2}
    assert [spans for spans, _ in inside] == [["dlsch.turbo_encode"]] * 2
    assert [(a[2], a[3]) for _, a in inside] == [
        (2 * len(members), k) for k, members in plan.k_groups.items()]


def test_dlsch_encode_matches_jax(rng):
    """The codeword bits of the port's DL-SCH encode (the twin on the CPU)
    equal the JAX package's on a TB of a K- and a K+ block with filler
    bits, which encode as the zeros they are and which the bit selection
    skips."""
    jplan = JaxPlan(tbs=6500, g=13200, qm=2, rv=1)
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    assert len(plan.k_groups) == 2 and plan.segm.f > 0
    tb = rng.integers(0, 2, size=(2, jplan.tbs)).astype(np.int8)
    got = sch.dlsch_encode(torch.as_tensor(tb), plan)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_dlsch_encode(jnp.asarray(tb), jplan)))

"""The PDCCH transmit kernel (csrc/pdcch_tx.cu) on the CPU.

The plain twin ``_pdcch_encode_plain`` is the code ``pdcch_encode`` was
before the kernel, bit for bit, and ``pdcch_encode_many``'s CPU path adds
its contributions as the composer did; both lie on the specification's
control region (``phybench/references``) at 1, 2 and 4 ports, 6, 25 and
100 PRB, CFI 1-3, L 1, 2, 4 and 8 and 1-3 DCIs. The kernel's arithmetic,
emulated in NumPy on the arguments the wrapper passes its launcher (the
card's path taken, the launch recorded, not made), reproduces the twin bit
for bit: the CRC16 and RNTI mask, the tail-biting code in its parity form
(against the trellis walk at every K from 28 to 80), the rate matching's
circle table read cyclically, the scrambling offset, QPSK and the SFBC /
SFBC-FSTD pairing. A transmitter call's control range makes one launch
and no host read, and on a card replays from one chain of CUDA graphs
per shape, whatever its RNTIs, CCEs, levels and HIs; the wrappers refuse
what the kernel does not take. The CUDA source itself,
built by ``g++`` with a header that runs each block's threads as host
threads and its barriers as ``std::barrier``, takes the wrapper's launches
in place of the card and reproduces the twin bit for bit at every case.
On a card ``chip_smoke.py --phases pdcch_tx`` holds the kernel to the twin.
"""

import contextlib
import ctypes
import re
import subprocess
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch.models import dci as dci_mod
from empower_srslte_tpu_torch.models import enb_dl, pcfich, pdcch, phich, ra
from empower_srslte_tpu_torch.models.pdsch import PdschConfig
from empower_srslte_tpu_torch.models.regs import pdcch_nof_cces
from empower_srslte_tpu_torch.ops.equalizer import (MimoType,
                                                    precode_diversity)
from empower_srslte_tpu_torch.ops.fec.convcoder import conv_encode
from empower_srslte_tpu_torch.ops.fec.rm_conv import (_circle, _selection,
                                                      rm_conv_tx)
from empower_srslte_tpu_torch.ops.modem import Mod, modulate
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.bits import uint_to_bits
from empower_srslte_tpu_torch.utils.cell import Cell
from empower_srslte_tpu_torch.utils.device import host_ints
from empower_srslte_tpu_torch.utils.crc import CRC16
from empower_srslte_tpu_torch.utils.cuda_build import CSRC, KERNELS, cxx
from empower_srslte_tpu_torch.utils.sequence import (cinit_pdcch,
                                                     gold_sequence)
from phybench.references import dl_control, dl_tm2, dl_tx

from tests.torch_fake_launch import fake_launches

RNTI, SF_IDX = 0x1234, 1
#: (PRB, ports, CFI) of the twin and emulation cases
CASES = [(prb, ports, cfi) for prb in (6, 25, 100) for ports in (1, 2, 4)
         for cfi in (1, 2, 3)]
#: float32 1/sqrt(2), the kernel's and ``modulate``'s
S = np.float32(1 / np.sqrt(2))
POLYS = (0o133, 0o171, 0o165)
#: |port - reference|: the reference's SFBC gives x / sqrt(2) = +-1/2 in
#: float64, the port float32(1/sqrt(2))^2 rounded, 3.0e-8 below it in each
#: of the two parts
REF_TOL = 4.3e-8


def _case_id(c):
    return "{}prb_{}p_cfi{}".format(*c)


def _cell(prb, ports, cfi) -> Cell:
    # cell ids off the multiples of 3, where the PCFICH's REGs depart from
    # 36.211 (PERF.md, Open questions)
    return Cell(nof_prb=prb, nof_ports=ports, id=3 * prb + cfi % 2 + 1)


def _dcis(cell, cfi, seed, count=3, sizes=None, levels=(8, 4, 2, 1),
          rntis=(RNTI,)):
    """Up to ``count`` DCIs (bits int8, rnti, cce, L) of random payloads
    on disjoint CCEs of the region, each at the first aligned CCE free
    for the next level of ``levels`` (cycled) that fits, the RNTIs and
    sizes cycled too."""
    g = torch.Generator().manual_seed(seed)
    n_cce = pdcch_nof_cces(cell, cfi)
    sizes = sizes or (dci_mod.format1_size(cell.nof_prb),
                      dci_mod.format0_1a_size(cell.nof_prb))
    used, out = set(), []
    for i in range(4 * count):
        if len(out) == count:
            break
        l = levels[i % len(levels)]
        cce = next((c for c in range(0, n_cce - l + 1, l)
                    if used.isdisjoint(range(c, c + l))), None)
        if cce is None:
            continue
        used.update(range(cce, cce + l))
        size = sizes[len(out) % len(sizes)]
        out.append((torch.randint(0, 2, (size,), generator=g,
                                  dtype=torch.int8),
                    rntis[len(out) % len(rntis)], cce, l))
    return out


# --- the code before the kernel, as it was ----------------------------------


def _parent_pdcch_encode(dci_bits, rnti, cce, l, cell, cfi, sf_idx, ng=1.0):
    dev = dci_bits.device
    e = l * pdcch.BITS_PER_CCE
    crc = CRC16.compute(dci_bits).to(torch.int8)
    mask = torch.as_tensor(uint_to_bits(rnti & 0xFFFF, 16), device=dev)
    payload = torch.cat([dci_bits.to(torch.int8),
                         torch.bitwise_xor(crc, mask)], dim=-1)
    coded = rm_conv_tx(conv_encode(payload), e)
    seq = gold_sequence(cinit_pdcch(2 * sf_idx, cell.id),
                        (cce + l) * pdcch.BITS_PER_CCE)[
        cce * pdcch.BITS_PER_CCE:]
    coded = torch.bitwise_xor(coded, torch.as_tensor(seq, device=dev))
    syms = modulate(coded, Mod.QPSK)
    idx = pdcch._region_idx(cell, cfi, ng, dev)[
        cce * pdcch.RE_PER_CCE:(cce + l) * pdcch.RE_PER_CCE]
    lead = syms.shape[:-1]
    ports = precode_diversity(syms, cell.nof_ports)
    grid = torch.zeros((*lead, cell.nof_ports, cell.nsymb_sf * cell.nof_re),
                       dtype=torch.complex64, device=dev)
    grid[..., idx] = ports
    return grid.reshape(*lead, cell.nof_ports, cell.nsymb_sf, cell.nof_re)


def _parent_control(cell, sf_idx, cfi, batch, dcis, phichs):
    """The composer's control range before the kernel: the PCFICH's and
    PHICH's symbols copied from the host, each PDCCH added on its own."""
    grid = enb_dl.enb_dl_base_grid(cell, sf_idx, (1,), "cpu")
    bits = torch.as_tensor(pcfich.CFI_CODEWORDS[cfi - 1])
    syms = modulate(torch.bitwise_xor(bits, torch.as_tensor(gold_sequence(
        ((sf_idx + 1) * (2 * cell.id + 1) << 9) + cell.id, 32))), Mod.QPSK)
    ports = precode_diversity(syms, cell.nof_ports)
    idx = torch.as_tensor(pcfich._re_indices(cell))
    grid = grid.clone()
    grid.view(1, cell.nof_ports, -1)[..., idx] = ports
    for ack, group, seq in phichs:
        z = np.tile(phich._W[seq], 3) * phich._scramble_seq(cell, sf_idx) * (
            -phich._BPSK0 if ack else phich._BPSK0)
        port_syms = precode_diversity(torch.as_tensor(z.astype(np.complex64)),
                                      cell.nof_ports)
        if cell.nof_ports == 4:
            port_syms = phich._fstd_alternate(port_syms, group)
        gidx = phich._group_idx(cell, 1.0, group, "cpu")
        out = grid.clone()
        out.view(1, cell.nof_ports, -1)[..., gidx] += port_syms
        grid = out
    for b, rnti, cce, l in dcis:
        grid = grid + _parent_pdcch_encode(torch.as_tensor(b), rnti, cce, l,
                                           cell, cfi, sf_idx)
    return grid.expand(batch, -1, -1, -1).contiguous()


# --- the kernel's arithmetic in NumPy ---------------------------------------


def emulate_payload(bits: np.ndarray, rnti: int) -> np.ndarray:
    """u [K]: the bits, then the bit-serial CRC16 XOR the RNTI, MSB first."""
    size = len(bits)
    u = np.zeros(size + 16, np.uint8)
    u[:size] = bits
    reg = 0
    for i in range(size + 16):
        reg = (reg << 1) | (int(u[i]) if i < size else 0)
        if reg & 0x10000:
            reg ^= 0x11021
    crc = (reg ^ rnti) & 0xFFFF
    u[size:] = [(crc >> (15 - j)) & 1 for j in range(16)]
    return u


def emulate_parity(u: np.ndarray, f: int) -> int:
    """d of flat position ``f`` of [3, K]: generator f // K's parity over
    u((i - t) mod K), t = 0..6."""
    k = len(u)
    j, i = divmod(f, k)
    d = 0
    for t in range(7):
        at = i - t + k if i - t < 0 else i - t
        d ^= (POLYS[j] >> (6 - t)) & int(u[at])
    return d


def emulate_ports(sym, ports: int):
    """A quadruplet's 4 QPSK symbols (float32 pairs) -> {(port, n): value}
    of the REs the kernel writes, its float32 products."""
    def scaled(x, y):
        return (np.float32(x) * S, np.float32(y) * S)

    if ports == 1:
        return {(0, n): sym[n] for n in range(4)}
    out = {}
    for h in range(2):
        n = 2 * h
        (a0, b0), (a1, b1) = sym[n], sym[n + 1]
        p, p2 = (0, 1) if ports == 2 else (h, 2 + h)
        out[p, n], out[p, n + 1] = scaled(a0, b0), scaled(a1, b1)
        out[p2, n], out[p2, n + 1] = scaled(-a1, b1), scaled(a0, -b0)
    return out


def emulate_launch(args, tensors):
    """One launch of ``pdcch_tx_launch`` in NumPy, from its recorded
    arguments (pointers resolved through ``tensors``, each tensor by its
    data pointer): adds onto the grid tensor in place, block by block."""
    (grid_p, row_stride, port_stride, ports, rows, re_p, sgn_p, n_re, n,
     bits_a, strides_a, sizes_a, circles_a, place_p, _stream) = args
    by_ptr = {t.data_ptr(): t for t in tensors}
    flat = by_ptr[grid_p].view(-1)
    re_t, sgn = by_ptr[re_p].numpy(), by_ptr[sgn_p].numpy()
    assert len(re_t) == n_re
    places = by_ptr[place_p].numpy()
    for d in range(n):
        size = sizes_a[d]
        rnti, cce, level = places[d].tolist()
        src = by_ptr[bits_a[d]].reshape(-1).numpy()
        circle = by_ptr[circles_a[d]].numpy()
        for row in range(rows):
            bits = src[row * strides_a[d]:row * strides_a[d] + size]
            u = emulate_payload(bits, rnti)
            k = len(u)
            assert len(circle) == 3 * k
            re_d = re_t[cce * 36:]
            sgn_d = sgn[cce * 72:]
            base = row * row_stride
            for q in range(level * 9):
                sym = []
                for b in range(0, 8, 2):
                    pair = []
                    for e in (8 * q + b, 8 * q + b + 1):
                        d_bit = emulate_parity(u, int(circle[e % (3 * k)]))
                        flip = (sgn_d[e] < 0) != (d_bit != 0)
                        pair.append(-S if flip else S)
                    sym.append(tuple(pair))
                for (p, nn), (x, y) in emulate_ports(sym, ports).items():
                    at = base + p * port_stride + int(re_d[4 * q + nn])
                    g = flat[at]
                    flat[at] = torch.complex(
                        torch.tensor(np.float32(g.real.item()) + x),
                        torch.tensor(np.float32(g.imag.item()) + y))


def _card_path(monkeypatch):
    """The card's path on CPU tensors: the launches recorded, not made."""
    monkeypatch.setattr(pdcch, "_on_card", lambda t: True)
    return fake_launches(monkeypatch, pdcch.PDCCH_TX)


# --- the twin ---------------------------------------------------------------


def _reference(cell, cfi, dcis, monkeypatch):
    """The specification's control region of the PCFICH and ``dcis`` (all
    of RNTI), [P, nsymb, 12 N_RB] complex128: ``dl_tx`` on 2 ports and on
    1, where the one port carries the symbols with no transmit diversity
    (36.211 6.3.4.1); ``dl_tm2`` on 4."""
    conf = {"nof_prb": cell.nof_prb, "cell_id": cell.id, "sf_idx": SF_IDX,
            "cfi": cfi, "rnti": RNTI}
    args = (conf, [(b.numpy(), l, cce) for b, _rnti, cce, l in dcis])
    if cell.nof_ports == 4:
        return dl_tm2.control_region(*args)
    if cell.nof_ports == 2:
        return dl_tx.control_region(*args, [])
    with monkeypatch.context() as m:
        m.setattr(dl_control, "tx_diversity",
                  lambda d: np.stack([d, np.zeros_like(d)]))
        return dl_tx.control_region(*args, [])[:1]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_twin_is_the_code_before_and_the_specification(case, monkeypatch):
    prb, ports, cfi = case
    cell = _cell(prb, ports, cfi)
    sizes = None if prb != 100 else (dci_mod.format1_size(100),
                                     dci_mod.format0_1a_size(100))
    dcis = _dcis(cell, cfi, seed=sum(case), count=1 + sum(case) % 3,
                 sizes=sizes, levels=((1, 2, 4, 8), (8, 4, 2, 1),
                                      (2, 8, 1, 4))[sum(case) % 3])
    assert dcis
    grid = pcfich.pcfich_put(torch.zeros((1, ports, cell.nsymb_sf,
                                          cell.nof_re),
                                         dtype=torch.complex64),
                             cfi, cell, SF_IDX)
    before = grid.clone()
    pdcch.pdcch_encode_many(grid, dcis, cell, cfi, SF_IDX)
    for b, rnti, cce, l in dcis:
        got = pdcch.pdcch_encode(b, rnti, cce, l, cell, cfi, SF_IDX)
        assert torch.equal(got, pdcch._pdcch_encode_plain(
            b, rnti, cce, l, cell, cfi, SF_IDX))
        assert torch.equal(got, _parent_pdcch_encode(b, rnti, cce, l, cell,
                                                     cfi, SF_IDX))
        before = before + got
    assert torch.equal(grid, before)
    ref = _reference(cell, cfi, dcis, monkeypatch)
    n = ref.shape[-2]
    ours = grid[0, :, :n].to(torch.complex128)
    assert not grid[0, :, n:].abs().any()
    assert torch.equal(ours != 0, ref != 0)
    assert torch.equal(torch.sign(ours.real), torch.sign(ref.real))
    assert torch.equal(torch.sign(ours.imag), torch.sign(ref.imag))
    assert float((ours - ref).abs().max()) < REF_TOL
    if ports == 1:                     # no product: the reference, rounded
        assert torch.equal(grid[0, :, :n], ref.to(torch.complex64))


# --- the kernel's arithmetic ------------------------------------------------


@pytest.mark.parametrize("k", range(28, 81))
def test_parity_form_is_the_trellis_walk(k):
    """The tail-biting code as the kernel computes it, d_j(i) the parity
    of g_j over u((i - t) mod K), equals ``conv_encode``'s bit walk."""
    g = torch.Generator().manual_seed(k)
    u = torch.randint(0, 2, (4, k), generator=g, dtype=torch.int8)
    u[1], u[2] = 0, 1
    walk = conv_encode(u).numpy().reshape(4, 3 * k)
    for row in range(4):
        un = u[row].numpy().astype(np.uint8)
        assert [emulate_parity(un, f) for f in range(3 * k)] \
            == walk[row].tolist()


@pytest.mark.parametrize("level", (1, 2, 4, 8))
def test_circle_is_the_rate_matching(level):
    """The circle table the kernel reads (``rmc_circle``), read cyclically
    modulo 3K as the kernel reads it, is ``rm_conv_tx``'s selection at
    every K of the blind kernel's range."""
    e = 72 * level
    for k in range(17, pdcch.MAX_K + 1):
        circle = _circle(k)
        assert sorted(circle) == list(range(3 * k))
        np.testing.assert_array_equal(circle[np.arange(e) % (3 * k)],
                                      _selection(k, e))


@pytest.mark.parametrize("size", (19, 27, 39, 55, 62))
def test_payload_is_the_crc_and_mask(size):
    g = torch.Generator().manual_seed(size)
    for rnti in (0, 0x1234, 0xFFFF, 0x1FFFF):
        bits = torch.randint(0, 2, (size,), generator=g, dtype=torch.int8)
        want = torch.cat([bits, torch.bitwise_xor(
            CRC16.compute(bits).to(torch.int8),
            torch.as_tensor(uint_to_bits(rnti & 0xFFFF, 16)))])
        np.testing.assert_array_equal(
            emulate_payload(bits.numpy(), rnti & 0xFFFF), want.numpy())


@pytest.mark.parametrize("ports", (1, 2, 4))
def test_pairing_is_precode_diversity(ports):
    """The kernel's port mapping of a quadruplet (SFBC-FSTD: the first
    pair on ports 0 and 2, the second on 1 and 3) is
    ``precode_diversity``'s, the REs it leaves untouched 0 there."""
    g = torch.Generator().manual_seed(ports)
    bits = torch.randint(0, 2, (8 * 9,), generator=g, dtype=torch.int8)
    syms = modulate(bits, Mod.QPSK)
    want = precode_diversity(syms, ports)
    got = torch.zeros_like(want)
    s = syms.numpy()
    for q in range(9):
        quad = [(np.float32(z.real), np.float32(z.imag))
                for z in s[4 * q:4 * q + 4]]
        for (p, n), (x, y) in emulate_ports(quad, ports).items():
            got[p, 4 * q + n] = complex(x, y)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ports", (1, 2, 4))
def test_scrambling_offset(ports):
    """Signs cce*72 on of the kernel's table are the twin's sequence of
    the CCE's PDCCH."""
    cell = _cell(100, ports, 3)
    _re, sgn = pdcch._region_tables(cell, 3, 1.0, SF_IDX, "cpu")
    c_init = cinit_pdcch(2 * SF_IDX, cell.id)
    for l in (1, 2, 4, 8):
        for cce in range(0, pdcch_nof_cces(cell, 3) - l + 1, l):
            seq = gold_sequence(c_init, (cce + l) * 72)[cce * 72:]
            np.testing.assert_array_equal(
                sgn[cce * 72:(cce + l) * 72].numpy() < 0, seq == 1)


#: (PRB, ports, CFI, leading dims, DCIs, bits) of the emulation cases
EMULATION = [(6, 1, 3, (), 2, "random"), (6, 2, 2, (2,), 1, "ones"),
             (25, 4, 3, (), 3, "zeros"), (25, 2, 3, (), 3, "random"),
             (100, 2, 1, (), 2, "random"), (100, 4, 2, (1,), 3, "random"),
             (100, 1, 1, (2,), 2, "rows"), (25, 1, 2, (), 1, "ones")]


@pytest.mark.parametrize("case", EMULATION,
                         ids=lambda c: "{}prb_{}p_cfi{}_{}lead_{}dci_{}"
                         .format(c[0], c[1], c[2], len(c[3]), c[4], c[5]))
def test_kernel_arithmetic_reproduces_the_twin(case, monkeypatch):
    """The launch the wrapper makes, emulated on its own arguments, adds
    onto the grid exactly what the twin adds: every DCI, every row."""
    prb, ports, cfi, lead, count, kind = case
    cell = _cell(prb, ports, cfi)
    dcis = _dcis(cell, cfi, seed=prb + ports + cfi, count=count,
                 rntis=(RNTI, 0xFFFF, 0x003D))
    assert len(dcis) == count
    if kind in ("ones", "zeros"):
        dcis = [(torch.full_like(b, int(kind == "ones")), r, c, l)
                for b, r, c, l in dcis]
    if kind == "rows":
        g = torch.Generator().manual_seed(5)
        dcis = [(torch.randint(0, 2, (*lead, b.shape[-1]), generator=g,
                               dtype=torch.int8), r, c, l)
                for b, r, c, l in dcis]
    shape = (*lead, ports, cell.nsymb_sf, cell.nof_re)
    g = torch.Generator().manual_seed(1)
    start = torch.complex(torch.randn(shape, generator=g),
                          torch.randn(shape, generator=g))
    want = start.clone()
    pdcch.pdcch_encode_many(want, dcis, cell, cfi, SF_IDX)
    launched = _card_path(monkeypatch)
    got = start.clone()
    bits = [b for b, *_ in dcis]
    places = host_ints([at for _, *at in pdcch.tx_dcis(
        dcis, cell, cfi, lead, got.device)], "cpu")
    pdcch.pdcch_encode_at(got, bits, places, cell, cfi, SF_IDX)
    assert len(launched) == 1 and launched[0][0] == "pdcch_tx"
    tables = pdcch._region_tables(cell, cfi, 1.0, SF_IDX, "cpu")
    circles = [pdcch.device_table(("rmc_circle", b.shape[-1] + 16), "cpu",
                                  None) for b in bits]
    emulate_launch(launched[0][2], [got, *tables, *circles, places, *bits])
    assert torch.equal(got, want)


def test_kernel_source_limits_are_the_wrappers():
    src = (CSRC / "pdcch_tx.cu").read_text()
    assert "pdcch_tx" in KERNELS
    assert int(re.search(r"#define MAX_DCIS (\d+)", src)[1]) \
        == pdcch.MAX_TX_DCIS
    assert int(re.search(r"#define MAX_K (\d+)", src)[1]) == pdcch.MAX_K


#: what csrc/pdcch_tx.cu needs of CUDA to build with g++ and run on the
#: CPU: a block's threads as host threads (blocks one after the other, so
#: static locals serve as its shared memory), __syncthreads as a barrier,
#: float32 products and sums each rounded once
CPU_CUDA_H = r"""
#pragma once
#include <barrier>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static thread_local dim3 threadIdx, blockIdx;
static std::barrier<>* block_barrier;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __shared__ static
#define __launch_bounds__(...)
#define __syncthreads() block_barrier->arrive_and_wait()
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
template <class K, class A>
void launch_on_cpu(K kernel, dim3 grid, int threads, const A& a) {
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      std::barrier<> bar(threads);
      block_barrier = &bar;
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(x, y);
          kernel(a);
        });
      for (auto& th : pool) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """``pdcch_tx_launch`` of csrc/pdcch_tx.cu built by g++ against
    ``CPU_CUDA_H``, its kernel launch made on the CPU."""
    out = tmp_path_factory.mktemp("pdcch_tx_cpu")
    (out / "cuda_runtime.h").write_text(CPU_CUDA_H)
    src, n = re.subn(
        r"(\w+)<<<(.*),\s*(\w+),\s*0,\s*\(cudaStream_t\)stream>>>\((\w+)\);",
        r"launch_on_cpu(\1, \2, \3, \4);",
        (CSRC / "pdcch_tx.cu").read_text(), flags=re.S)
    assert n == 1
    (out / "pdcch_tx.cpp").write_text(src)
    lib = out / "libpdcch_tx_cpu.so"
    subprocess.run([cxx(), "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(out), "-o", str(lib), str(out / "pdcch_tx.cpp")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).pdcch_tx_launch
    fn.argtypes = pdcch.PDCCH_TX.argtypes
    fn.restype = ctypes.c_int
    return fn


def _source_on_cpu(monkeypatch, fn):
    """The card's path on CPU tensors, each launch made by the CUDA source
    built for the CPU: -> the launches' (name, shape) records."""
    monkeypatch.setattr(pdcch, "_on_card", lambda t: True)
    monkeypatch.setattr(pdcch.PDCCH_TX, "_fn", fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    trace.reset()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_source_on_the_cpu_reproduces_the_twin(case, cpu_kernel,
                                                    monkeypatch):
    """The kernel's own source, run on the CPU through the wrapper, adds
    onto a random grid what the twin adds, bit for bit: 1-3 DCIs, all
    levels, random, all-zero and all-one payloads, one row and two."""
    prb, ports, cfi = case
    cell = _cell(prb, ports, cfi)
    dcis = _dcis(cell, cfi, seed=7 * sum(case), count=1 + sum(case) % 3,
                 levels=((2, 8, 1, 4), (1, 2, 4, 8), (8, 4, 2, 1))[cfi - 1],
                 rntis=(RNTI, 0xFFFF, 0x0001))
    kind = sum(case) % 3
    if kind:
        dcis = [(torch.full_like(b, kind - 1), r, c, l) for b, r, c, l in dcis]
    lead = (2,) if prb == 25 else ()
    shape = (*lead, ports, cell.nsymb_sf, cell.nof_re)
    g = torch.Generator().manual_seed(prb)
    start = torch.complex(torch.randn(shape, generator=g),
                          torch.randn(shape, generator=g))
    want = start.clone()
    pdcch.pdcch_encode_many(want, dcis, cell, cfi, SF_IDX)
    _source_on_cpu(monkeypatch, cpu_kernel)
    got = start.clone()
    pdcch.pdcch_encode_many(got, dcis, cell, cfi, SF_IDX)
    assert trace.launch_counts() == {"pdcch_tx": 1}
    assert torch.equal(got, want)
    one = pdcch.pdcch_encode(dcis[0][0], *dcis[0][1:], cell, cfi, SF_IDX)
    assert torch.equal(one, pdcch._pdcch_encode_plain(
        dcis[0][0], *dcis[0][1:], cell, cfi, SF_IDX))


def test_cuda_source_launcher_refuses_what_the_kernel_does_not_take(
        cpu_kernel):
    """The launcher refuses what it sees on the host; a place the kernel
    reads on the card and does not take (a level, or CCEs off the region)
    writes nothing."""
    grid = torch.zeros(2 * 1200, dtype=torch.complex64)
    re_t = torch.arange(144, dtype=torch.int32)
    sgn = torch.ones(288)
    bits = torch.zeros(27, dtype=torch.int8)
    circle = torch.as_tensor(_circle(27 + 16))

    def launch(n=1, ports=2, size=27, cce=0, l=4, rows=1, n_re=144):
        m = max(n, 1)
        place = torch.tensor([[1, cce, l]] * m, dtype=torch.int32)
        return cpu_kernel(
            grid.data_ptr(), 2400, 1200, ports, rows, re_t.data_ptr(),
            sgn.data_ptr(), n_re, n,
            (ctypes.c_void_p * m)(*[bits.data_ptr()] * m),
            (ctypes.c_longlong * m)(*[0] * m), (ctypes.c_int * m)(*[size] * m),
            (ctypes.c_void_p * m)(*[circle.data_ptr()] * m),
            place.data_ptr(), None)

    assert launch() == 0 and grid.abs().any()
    for bad in (dict(n=0), dict(n=9), dict(ports=3), dict(size=113),
                dict(size=0), dict(rows=0)):
        assert launch(**bad) != 0, bad
    for off in (dict(l=3), dict(cce=-1), dict(cce=1), dict(n_re=143)):
        grid.zero_()
        assert launch(**off) == 0 and not grid.abs().any(), off


# --- the composer and the launches ------------------------------------------


def _tx_grant(prb, ports):
    cell = Cell(nof_prb=prb, nof_ports=ports, id=1)
    mod, tbs = ra.mcs_to_tbs(10, prb)
    mimo = {1: MimoType.SINGLE, 2: MimoType.SPATIAL_MUX,
            4: MimoType.DIVERSITY}[ports]
    cfg = PdschConfig(cell=cell, sf_idx=SF_IDX, cfi=2, rnti=RNTI, mod=mod,
                      mimo=mimo, nof_layers={1: 1, 2: 2, 4: 4}[ports],
                      nof_codewords=2 if ports == 2 else 1)
    g = torch.Generator().manual_seed(prb + ports)
    tb = torch.randint(0, 2, (2, 2, tbs), generator=g, dtype=torch.int8)
    dcis = _dcis(cell, 2, seed=ports, count=2, levels=(2, 1, 4))
    phichs = [(1, 0, 3)] if ports != 4 else [(0, 1, 2)]
    return cfg, cfg.plan(tbs), tb, dcis, phichs


@pytest.mark.parametrize("prb,ports", [(6, 1), (6, 2), (25, 4)])
def test_composer_is_the_parents(prb, ports):
    """``enb_dl_compose`` on the CPU: the grid the parent composed, the
    control region and the PDSCH written into it."""
    cfg, plan, tb, dcis, phichs = _tx_grant(prb, ports)
    cell = cfg.cell
    tb2 = tb[1] if cfg.nof_codewords == 2 else None
    got = enb_dl.enb_dl_compose(cell, SF_IDX, 2, 2, dcis=dcis, phichs=phichs,
                                pdschs=[(tb[0], cfg, plan, tb2)],
                                device="cpu")
    want = _parent_control(cell, SF_IDX, 2, 2, dcis, phichs)
    from empower_srslte_tpu_torch.models.pdsch import pdsch_encode

    pdsch_encode(tb[0], cfg, plan, tb2, None if tb2 is None else plan,
                 grid=want)
    assert torch.equal(got, want)


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


def test_control_range_makes_one_launch_and_no_host_read(monkeypatch):
    """With the card's path taken, an ``enb_dl_tx_batch`` call's
    ``enb_dl.control_tx`` launches the kernel once for both DCIs, counted
    in the launch registry under (DCIs, ports, largest K), and holds no
    op that reads a value back to the host."""
    cfg, plan, tb, dcis, phichs = _tx_grant(6, 2)
    launched = _card_path(monkeypatch)
    run = lambda: enb_dl.enb_dl_tx_batch(tb[0], cfg, plan, tb2=tb[1],
                                         dcis=dcis, phichs=phichs)
    run()                                              # tables built
    launched.clear()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert [name for name, *_ in launched] == ["pdcch_tx"]
    k = max(b.shape[-1] for b, *_ in dcis) + 16
    assert trace.launch_shapes("pdcch_tx") == {(2, 2, k): 1}
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name == "enb_dl.control_tx"]
    assert len(ranges) == 1
    held = {e.name for e in cpu if _inside(e, ranges[0])}
    assert held and not held & {"aten::item", "aten::_local_scalar_dense",
                                "aten::lift_fresh"}, held


def test_control_chain_is_one_a_control_configuration():
    """The batched transmitter's control range: on the CPU the eager
    stages; on a card one chain of CUDA graphs per cell, subframe, CFI,
    batch, number of HIs and the DCIs' sizes and types. The DCIs' bits,
    RNTIs, CCEs and levels and the HIs' values are left out of the key,
    since every call copies them in."""
    from empower_srslte_tpu_torch.runtime import graphs

    cell = _cell(25, 2, 2)
    dcis = _dcis(cell, 2, seed=3, count=2)
    other = [(1 - b, 0xFFFF - rnti, cce + 4 * (i == 0), 1)
             for i, (b, rnti, cce, _l) in enumerate(dcis)]
    phichs = [(1, 0, 3)]
    assert enb_dl._control_chain(cell, 1, 2, 4, dcis, phichs,
                                 torch.device("cpu")) is graphs.EAGER
    card = torch.device("cuda", 0)
    chain = enb_dl._control_chain(cell, 1, 2, 4, dcis, phichs, card)
    try:
        assert isinstance(chain, graphs.Stages) and chain._device == card
        for kw in (dict(dcis=other), dict(phichs=[(0, 1, 5)])):
            args = dict(batch=4, dcis=dcis, phichs=phichs) | kw
            assert enb_dl._control_chain(cell, 1, 2, 4, args["dcis"],
                                         args["phichs"], card) is chain
        for kw in (dict(batch=8), dict(phichs=[]), dict(phichs=phichs * 2),
                   dict(dcis=dcis[:1]), dict(dcis=()),
                   dict(dcis=[(dcis[0][0].long(), *dcis[0][1:])]),
                   dict(dcis=[(dcis[0][0][:-1], *dcis[0][1:])]),
                   dict(sf=2), dict(cfi=3)):
            args = dict(sf=1, cfi=2, batch=4, dcis=dcis, phichs=phichs) | kw
            assert enb_dl._control_chain(
                cell, args["sf"], args["cfi"], args["batch"], args["dcis"],
                args["phichs"], card) is not chain
    finally:
        enb_dl._CHAINS.clear()


class _RecordingStages:
    """Stages that run as ``EAGER`` does and record each stage's tensor
    arguments."""

    def __init__(self):
        self.tensors = []

    def __call__(self, name, fn, *args):
        self.tensors.append([a for a in args if isinstance(a, torch.Tensor)])
        return fn(*args)


@pytest.mark.parametrize("his,n_dcis", [(0, 0), (1, 0), (0, 1), (2, 2)])
def test_control_range_of_any_count_is_the_parents(his, n_dcis):
    """No DCI, no HI, or both: the composer's control range is the
    parent's, and its stage has the values as a host tensor argument,
    even when empty (a chain copies it into its buffer every call)."""
    cfg, plan, tb, dcis, phichs = _tx_grant(25, 2)
    phichs = [(1, 0, 3), (0, 2, 6)][:his]
    dcis = dcis[:n_dcis]
    stages = _RecordingStages()
    got = enb_dl.enb_dl_compose(cfg.cell, SF_IDX, 2, 2, dcis=dcis,
                                phichs=phichs, device="cpu", stages=stages)
    want = _parent_control(cfg.cell, SF_IDX, 2, 2, dcis, phichs)
    assert torch.equal(got, want)
    assert len(stages.tensors) == 1 and stages.tensors[0]
    values = stages.tensors[0][0]
    assert values.device.type == "cpu" and values.dtype == torch.int32
    assert tuple(values.shape) == (his + n_dcis, 3)


@pytest.mark.parametrize("hi", [(2, 0, 0), (0, 99, 0), (1, 0, 8),
                                (0, -1, 0)])
def test_composer_refuses_an_hi_off_the_phich(hi):
    cell = _cell(25, 2, 2)
    with pytest.raises(ValueError, match="HI"):
        enb_dl.enb_dl_compose(cell, SF_IDX, 2, 1, phichs=[hi],
                              device="cpu")


def test_phich_put_reads_its_hi_from_tensors():
    """``phich_put`` with (ack, group, seq) as int tensors [1] adds what
    it adds with the ints, for every ACK, group and sequence, 2 and 4
    ports."""
    from empower_srslte_tpu_torch.models.regs import nof_phich_groups

    for ports in (2, 4):
        cell = _cell(25, ports, 1)
        g = torch.Generator().manual_seed(ports)
        shape = (2, ports, cell.nsymb_sf, cell.nof_re)
        start = torch.complex(torch.randn(shape, generator=g),
                              torch.randn(shape, generator=g))
        for group in range(nof_phich_groups(cell, 1.0)):
            for seq in range(8):
                for ack in (0, 1):
                    want = phich.phich_put(start, ack, cell, SF_IDX, group,
                                           seq)
                    got = phich.phich_put(
                        start, torch.tensor([ack]), cell, SF_IDX,
                        torch.tensor([group], dtype=torch.int32),
                        torch.tensor([seq], dtype=torch.int32))
                    assert torch.equal(got, want), (ports, group, seq, ack)


def test_many_dcis_take_a_launch_a_eight(monkeypatch):
    cell = _cell(100, 2, 3)
    dcis = _dcis(cell, 3, seed=9, count=11, levels=(1,))
    assert len(dcis) == 11
    launched = _card_path(monkeypatch)
    grid = torch.zeros((2, cell.nsymb_sf, cell.nof_re), dtype=torch.complex64)
    pdcch.pdcch_encode_many(grid, dcis, cell, 3, SF_IDX)
    assert [args[8] for _name, _dev, args in launched] == [8, 3]


def test_no_launch_without_a_card():
    cell = _cell(25, 2, 2)
    trace.reset()
    pdcch.pdcch_encode_many(
        torch.zeros((2, cell.nsymb_sf, cell.nof_re), dtype=torch.complex64),
        _dcis(cell, 2, seed=1, count=2), cell, 2, SF_IDX)
    assert trace.launch_counts() == {}


def _refusals(cell, grid, bits):
    n_cce = pdcch_nof_cces(cell, 2)
    return [
        ("complex64", grid.to(torch.complex128), [(bits, RNTI, 0, 1)]),
        ("grid shape", grid[:1], [(bits, RNTI, 0, 1)]),
        ("integers", grid, [(bits.float(), RNTI, 0, 1)]),
        ("device", grid, [(bits.to("meta"), RNTI, 0, 1)]),
        ("tensor", grid, [(bits.numpy(), RNTI, 0, 1)]),
        ("leading dims", grid, [(bits[None].expand(3, -1), RNTI, 0, 1)]),
        ("must lie in", grid, [(torch.zeros(113, dtype=torch.int8), RNTI,
                                0, 1)]),
        ("does not fit", grid, [(bits, RNTI, 0, 3)]),
        ("does not fit", grid, [(bits, RNTI, n_cce - 1, 2)]),
        ("overlap", grid, [(bits, RNTI, 0, 2), (bits, RNTI, 1, 1)]),
    ]


@pytest.mark.parametrize("i", range(10))
def test_wrapper_refuses_what_the_kernel_does_not_take(i, monkeypatch):
    cell = _cell(25, 2, 2)
    grid = torch.zeros((2, cell.nsymb_sf, cell.nof_re), dtype=torch.complex64)
    bits = torch.zeros(27, dtype=torch.int8)
    match, g, dcis = _refusals(cell, grid, bits)[i]
    with pytest.raises(ValueError, match=match):
        pdcch.pdcch_encode_many(g, dcis, cell, 2, SF_IDX)
    launched = _card_path(monkeypatch)
    with pytest.raises(ValueError, match=match):
        pdcch.pdcch_encode_many(g, dcis, cell, 2, SF_IDX)
    assert launched == []


def test_card_path_refuses_a_strided_grid(monkeypatch):
    cell = _cell(6, 2, 1)
    dcis = _dcis(cell, 1, seed=2, count=1)
    launched = _card_path(monkeypatch)
    wide = torch.zeros((2, cell.nsymb_sf, 2 * cell.nof_re),
                       dtype=torch.complex64)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        pdcch.pdcch_encode_many(wide, dcis, cell, 1, SF_IDX)
    pdcch.pdcch_encode_many(wide.contiguous(), dcis, cell, 1, SF_IDX)
    assert len(launched) == 1

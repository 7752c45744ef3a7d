"""MIMO RX equalization ("predecoding") and TX precoding + layer mapping.

Capability parity with lib/src/phy/mimo/precoding.c and layermap.c:
single-port MRC/MMSE (precoding.c:63-354), 2-port SFBC and 4-port
SFBC-FSTD diversity (precoding.c:356-686, 1863-1889), 2x2 spatial
multiplexing ZF/MMSE with codebook rotation and CSI output
(precoding.c:1121-1764), TM3 large-delay CDD, PMI selection and the
condition number (precoding.c:2148-2923), TX precoding and layer
map/demap (layermap.c:38-221). Per-RE 2x2 solves are closed-form
elementwise arithmetic over the whole resource grid (mat.c:55-98).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from ..utils.device import device_table


class MimoType(enum.Enum):
    """Transmission scheme (srslte_mimo_type_t analog)."""

    SINGLE = "single"           # TM1: 1 layer, 1 port
    DIVERSITY = "diversity"     # TM2: SFBC (2 ports)
    SPATIAL_MUX = "multiplex"   # TM3/TM4: 2x2 spatial multiplexing
    CDD = "cdd"                 # TM3 open-loop large-delay CDD


# --- RX: equalization ------------------------------------------------------


def eq_single(y, h, noise_est=0.0):
    """SISO/SIMO MRC: y[..., A, n], h[..., A, n] -> (x[..., n], csi[..., n])
    with MMSE scaling: x = sum_a conj(h_a) y_a / (sum_a |h_a|^2 + N0)."""
    num = torch.sum(torch.conj(h) * y, dim=-2)
    den = torch.sum(h.abs() ** 2, dim=-2) + noise_est
    return num / torch.clamp(den, min=1e-20), den


def eq_sfbc(y, h0, h1):
    """2-port SFBC (Alamouti in frequency) combining, precoding.c:356-686.

    y[..., A, n] with n even; h0/h1 [..., A, n] per-port channels.
    Returns (x[..., n], csi[..., n]). TX mapping (36.211 6.3.4.3): on REs
    (2i, 2i+1) port0 sends (x0, x1), port1 (-x1*, x0*), scaled 1/sqrt(2).
    """
    ye = y[..., 0::2]
    yo = y[..., 1::2]
    h0e, h1e = h0[..., 0::2], h1[..., 0::2]
    x0 = torch.sum(torch.conj(h0e) * ye + h1e * torch.conj(yo), dim=-2)
    x1 = torch.sum(torch.conj(h0e) * yo - h1e * torch.conj(ye), dim=-2)
    hh = torch.sum(h0e.abs() ** 2 + h1e.abs() ** 2, dim=-2)
    hh = torch.clamp(hh, min=1e-20)
    scale = float(np.float32(math.sqrt(2.0)))
    x0 = x0 / hh * scale
    x1 = x1 / hh * scale
    out = torch.stack([x0, x1], dim=-1).reshape(*x0.shape[:-1], -1)
    csi = torch.repeat_interleave(hh, 2, dim=-1)
    return out, csi


def eq_mux_2x2_components(y0, y1, h00, h01, h10, h11, noise_est=0.0):
    """Component form of the 2x2 MMSE solve. Returns (x0, x1, csi0, csi1)."""
    a = h00.abs() ** 2 + h10.abs() ** 2 + noise_est       # (H^H H)_00
    d = h01.abs() ** 2 + h11.abs() ** 2 + noise_est       # (H^H H)_11
    b = torch.conj(h00) * h01 + torch.conj(h10) * h11     # (H^H H)_01
    det = torch.clamp(a * d - b.abs() ** 2, min=1e-20)
    hy0 = torch.conj(h00) * y0 + torch.conj(h10) * y1     # (H^H y)_0
    hy1 = torch.conj(h01) * y0 + torch.conj(h11) * y1
    x0 = (d * hy0 - b * hy1) / det
    x1 = (a * hy1 - torch.conj(b) * hy0) / det
    return (x0, x1, det / torch.clamp(d, min=1e-20),
            det / torch.clamp(a, min=1e-20))


def eq_mux_2x2(y, h, noise_est=0.0, mmse: bool = True):
    """2x2 spatial multiplexing MMSE (precoding.c:1121-1764, mat.c:63-98).

    y[..., 2, n] rx symbols, h[..., 2rx, 2tx, n] channel ->
    (x[..., 2, n] layer symbols, csi[..., 2, n]); csi_i =
    1 / [(H^H H + N0 I)^-1]_ii weights the LLRs. ``mmse=False`` returns
    unit CSI (the ZF weighting).
    """
    x0, x1, csi0, csi1 = eq_mux_2x2_components(
        y[..., 0, :], y[..., 1, :], h[..., 0, 0, :], h[..., 0, 1, :],
        h[..., 1, 0, :], h[..., 1, 1, :], noise_est)
    x = torch.stack([x0, x1], dim=-2)
    csi = torch.stack([csi0, csi1], dim=-2)
    return (x, csi) if mmse else (x, torch.ones_like(csi))


def eq_sfbc_fstd(y, h0, h1, h2, h3):
    """4-port SFBC-FSTD combining (precoding.c:356-686): Alamouti-combine
    REs (4i, 4i+1) with ports (0, 2) and REs (4i+2, 4i+3) with ports
    (1, 3). y, h0..h3 [..., A, n] with n % 4 == 0 -> (x, csi) [..., n]."""
    n = y.shape[-1]
    assert n % 4 == 0

    def pick(a, lo):
        q = a.reshape(*a.shape[:-1], n // 4, 4)
        return q[..., lo:lo + 2].reshape(*a.shape[:-1], n // 2)

    x_a, csi_a = eq_sfbc(pick(y, 0), pick(h0, 0), pick(h2, 0))
    x_b, csi_b = eq_sfbc(pick(y, 2), pick(h1, 2), pick(h3, 2))

    def weave(a, b):
        qa = a.reshape(*a.shape[:-1], n // 4, 2)
        qb = b.reshape(*b.shape[:-1], n // 4, 2)
        return torch.cat([qa, qb], dim=-1).reshape(*a.shape[:-1], n)

    return weave(x_a, x_b), weave(csi_a, csi_b)


# --- TX: layer mapping and precoding --------------------------------------


def layermap(cw_symbols, nof_layers: int, nof_codewords: int = 1):
    """Codeword(s) -> layers [..., nof_layers, M_layer] (36.211 6.3.3)."""
    if nof_codewords == 1 and nof_layers == 1:
        return cw_symbols[0][..., None, :]
    if nof_codewords == 1 and nof_layers == 2:
        x = cw_symbols[0]
        return torch.stack([x[..., 0::2], x[..., 1::2]], dim=-2)
    if nof_codewords == 2 and nof_layers == 2:
        return torch.stack(list(cw_symbols), dim=-2)
    if nof_codewords == 1 and nof_layers == 4:
        # 4-layer diversity: x^(l)(i) = d(4i + l) (36.211 Table 6.3.3.3-1)
        x = cw_symbols[0]
        return torch.stack([x[..., l::4] for l in range(4)], dim=-2)
    if nof_codewords == 2 and nof_layers == 3:
        # cw0 -> layer 0, cw1 -> layers 1/2 even-odd (layermap.c:112)
        x0, x1 = cw_symbols
        return torch.stack([x0, x1[..., 0::2], x1[..., 1::2]], dim=-2)
    if nof_codewords == 2 and nof_layers == 4:
        x0, x1 = cw_symbols
        return torch.stack([x0[..., 0::2], x0[..., 1::2],
                            x1[..., 0::2], x1[..., 1::2]], dim=-2)
    raise NotImplementedError((nof_codewords, nof_layers))


def _interleave(layers, idx) -> torch.Tensor:
    """Interleave layers[..., idx, :] symbol by symbol into one axis."""
    x = torch.stack([layers[..., i, :] for i in idx], dim=-1)
    return x.reshape(*layers.shape[:-2], -1)


def layerdemap(layers, nof_codewords: int = 1):
    """Layers -> list of codeword symbol tensors: inverse of layermap."""
    n_layers = layers.shape[-2]
    if nof_codewords == 1 and n_layers == 1:
        return [layers[..., 0, :]]
    if nof_codewords == 1 and n_layers in (2, 4):
        return [_interleave(layers, range(n_layers))]
    if nof_codewords == 2 and n_layers == 2:
        return [layers[..., 0, :], layers[..., 1, :]]
    if nof_codewords == 2 and n_layers == 3:
        return [layers[..., 0, :], _interleave(layers, (1, 2))]
    if nof_codewords == 2 and n_layers == 4:
        return [_interleave(layers, (0, 1)), _interleave(layers, (2, 3))]
    raise NotImplementedError((nof_codewords, n_layers))


def precode_single(layers):
    """TM1: identity (precoding.c precoding_single)."""
    return layers


def precode_sfbc(layers):
    """TM2 SFBC: [..., 2, M] layers -> [..., 2 ports, 2M] port symbols
    (36.211 6.3.4.3, precoding.c precoding_diversity)."""
    x0 = layers[..., 0, :]
    x1 = layers[..., 1, :]
    s = float(np.float32(1.0 / math.sqrt(2.0)))
    p0 = torch.stack([x0, x1], dim=-1).reshape(*x0.shape[:-1], -1) * s
    p1 = torch.stack([-torch.conj(x1), torch.conj(x0)], dim=-1).reshape(
        *x0.shape[:-1], -1) * s
    return torch.stack([p0, p1], dim=-2)


def precode_sfbc_fstd(layers):
    """4-port SFBC-FSTD (36.211 6.3.4.3; precoding.c:1863-1889): groups
    of 4 REs carry the Alamouti pair (x0, x1) on ports {0, 2} over REs
    (4i, 4i+1) and (x2, x3) on ports {1, 3} over REs (4i+2, 4i+3).
    layers [..., 4, M] -> ports [..., 4, 4M]."""
    x0, x1, x2, x3 = (layers[..., i, :] for i in range(4))
    z = torch.zeros_like(x0)
    s = float(np.float32(1.0 / math.sqrt(2.0)))

    def inter4(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1).reshape(*a.shape[:-1], -1)

    return torch.stack([
        inter4(x0, x1, z, z) * s,
        inter4(z, z, x2, x3) * s,
        inter4(-torch.conj(x1), torch.conj(x0), z, z) * s,
        inter4(z, z, -torch.conj(x3), torch.conj(x2)) * s], dim=-2)


def precode_diversity(syms, nof_ports: int):
    """A control channel's symbols [..., M] on ``nof_ports`` ports
    [..., P, M] (36.211 6.3.3.3, 6.3.4.3): the one port as they are, SFBC
    on 2 ports, SFBC-FSTD on 4 (M a multiple of 4)."""
    if nof_ports == 1:
        return syms[..., None, :]
    if nof_ports == 2:
        return precode_sfbc(layermap([syms], 2))
    return precode_sfbc_fstd(layermap([syms], 4))


def combine_diversity(y, h, noise_est=0.0):
    """The inverse of ``precode_diversity`` at one rx antenna: y [..., M]
    and h [..., M] (one port) or [..., P, M] -> (x [..., M], csi [..., M]):
    MRC over max(|h|^2 + noise, 1e-12) with csi |h|^2 on one port,
    ``eq_sfbc`` on ports 0 and 1 of a 2-port channel, ``eq_sfbc_fstd`` on
    a 4-port one."""
    if h.dim() == y.dim() or h.shape[-2] == 1:
        hh = h if h.dim() == y.dim() else h[..., 0, :]
        x = y * torch.conj(hh) / torch.clamp(hh.abs() ** 2 + noise_est,
                                             min=1e-12)
        return x, hh.abs() ** 2
    ports = [h[..., p, None, :] for p in range(h.shape[-2])]
    if len(ports) == 4:
        return eq_sfbc_fstd(y[..., None, :], *ports)
    return eq_sfbc(y[..., None, :], ports[0], ports[1])


def codebook_2x2(pmi: int) -> np.ndarray:
    """36.211 Table 6.3.4.2.3-1 codebook, 2 antenna ports, 2 layers (TM4)."""
    if pmi == 0:
        w = np.array([[1, 0], [0, 1]], np.complex64)
    elif pmi == 1:
        w = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2)
    elif pmi == 2:
        w = np.array([[1, 1], [1j, -1j]], np.complex64) / np.sqrt(2)
    else:
        raise ValueError(pmi)
    return (w / np.sqrt(2)).astype(np.complex64)


def _c(w) -> complex:
    return complex(np.complex64(w))


def precode_mux_2x2(layers, pmi: int = 0):
    """TM4 closed-loop 2-layer precoding: x_ports = W @ x_layers."""
    w = codebook_2x2(pmi)
    return torch.stack(
        [_c(w[p, 0]) * layers[..., 0, :] + _c(w[p, 1]) * layers[..., 1, :]
         for p in range(2)], dim=-2)


def effective_channel_mux(h, pmi: int = 0):
    """Fold the TM4 precoder into the per-port channel:
    h[..., rx, port, n] -> h_eff[..., rx, layer, n] = H W."""
    w = codebook_2x2(pmi)
    return torch.stack(
        [_c(w[0, l]) * h[..., 0, :] + _c(w[1, l]) * h[..., 1, :]
         for l in range(2)], dim=-2)


# --- PMI selection and channel condition (precoding.c:2148-2923) -----------


def pmi_select_2layer(h, noise_est=1e-4):
    """SINR-maximizing PMI for TM4 2-layer over the 2x2 codebook
    (srslte_precoding_pmi_select, precoding.c:2148-2886): h [..., rx,
    port, n] -> (pmi [...], per-PMI mean post-MMSE log-capacity [..., 3])."""
    caps = []
    for pmi in range(3):
        e = effective_channel_mux(h, pmi)
        e00, e01 = e[..., 0, 0, :], e[..., 0, 1, :]
        e10, e11 = e[..., 1, 0, :], e[..., 1, 1, :]
        a = e00.abs() ** 2 + e10.abs() ** 2 + noise_est
        d = e01.abs() ** 2 + e11.abs() ** 2 + noise_est
        b = torch.conj(e00) * e01 + torch.conj(e10) * e11
        det = torch.clamp(a * d - b.abs() ** 2, min=1e-20)
        # per-layer post-MMSE SINR_i = det / (noise * opposite diag) - 1
        s0 = det / (noise_est * torch.clamp(d, min=1e-20)) - 1.0
        s1 = det / (noise_est * torch.clamp(a, min=1e-20)) - 1.0
        caps.append(torch.mean(torch.log1p(torch.clamp(s0, min=0))
                               + torch.log1p(torch.clamp(s1, min=0)),
                               dim=-1))
    stack = torch.stack(caps, dim=-1)
    return torch.argmax(stack, dim=-1), stack


def pmi_select_1layer(h, noise_est=1e-4):
    """SINR-maximizing PMI for TM4 single layer over the 4-entry rank-1
    codebook (36.211 Table 6.3.4.2.3-2): w = [1, v]/sqrt(2),
    v in {1, -1, j, -j}. h [..., rx, port, n] -> (pmi [...], [..., 4])."""
    s = float(np.float32(math.sqrt(2.0)))
    sinrs = []
    for v in (1.0, -1.0, 1j, -1j):
        heff = (h[..., 0, :] + v * h[..., 1, :]) / s
        g = torch.sum(heff.abs() ** 2, dim=-2)           # over rx antennas
        sinrs.append(torch.mean(g, dim=-1) / noise_est)
    stack = torch.stack(sinrs, dim=-1)
    return torch.argmax(stack, dim=-1), stack


def condition_number_db(h):
    """Average 2x2 channel condition number in dB (srslte_precoding_cn,
    precoding.c:2889-2923; mat.c:107-127): h [..., rx, port, n] -> [...]."""
    a = h[..., 0, 0, :].abs() ** 2 + h[..., 1, 0, :].abs() ** 2
    d = h[..., 0, 1, :].abs() ** 2 + h[..., 1, 1, :].abs() ** 2
    b = (torch.conj(h[..., 0, 0, :]) * h[..., 0, 1, :]
         + torch.conj(h[..., 1, 0, :]) * h[..., 1, 1, :])
    tr = a + d
    det = torch.clamp(a * d - b.abs() ** 2, min=1e-20)
    disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
    lmax = (tr + disc) / 2
    lmin = torch.clamp((tr - disc) / 2, min=1e-20)
    return torch.mean(10 * torch.log10(lmax / lmin), dim=-1)


# --- TM3: open-loop spatial multiplexing with large-delay CDD ---------------


def _cdd_matrices():
    """W (fixed identity codebook entry) and U (DFT) for 2 layers
    (36.211 6.3.4.2.2); D(i) = diag(1, (-1)^i) cycles per RE."""
    w = np.array([[1, 0], [0, 1]], np.complex64) / np.sqrt(2)
    u = np.array([[1, 1], [1, np.exp(-2j * np.pi / 2)]],
                 np.complex64) / np.sqrt(2)
    return w, u


def _cdd_sign(n: int, device) -> torch.Tensor:
    """D(i)'s second entry, (-1)^i, by the index i of the RE in
    extraction order (not its grid position)."""
    return device_table(("cdd_sign", n), device, lambda: (
        1.0 - 2.0 * (np.arange(n) % 2)).astype(np.float32))


def precode_cdd_2layer(layers):
    """TM3 large-delay CDD: x_ports(i) = W D(i) U x_layers(i)
    (precoding.c precoding_cdd). layers [..., 2, n] -> ports [..., 2, n]."""
    w, u = _cdd_matrices()
    sign = _cdd_sign(layers.shape[-1], layers.device)
    l0, l1 = layers[..., 0, :], layers[..., 1, :]
    ux0 = _c(u[0, 0]) * l0 + _c(u[0, 1]) * l1
    ux1 = (_c(u[1, 0]) * l0 + _c(u[1, 1]) * l1) * sign
    return torch.stack([_c(w[p, 0]) * ux0 + _c(w[p, 1]) * ux1
                        for p in range(2)], dim=-2)


def effective_channel_cdd(h):
    """Fold W D(i) U into the per-port channel:
    h[..., rx, port, n] -> h_eff[..., rx, layer, n]."""
    w, u = _cdd_matrices()
    sign = _cdd_sign(h.shape[-1], h.device)
    hw0 = _c(w[0, 0]) * h[..., 0, :] + _c(w[1, 0]) * h[..., 1, :]
    hw1 = (_c(w[0, 1]) * h[..., 0, :] + _c(w[1, 1]) * h[..., 1, :]) * sign
    return torch.stack([hw0 * _c(u[0, m]) + hw1 * _c(u[1, m])
                        for m in range(2)], dim=-2)

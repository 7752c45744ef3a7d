"""MIMO RX equalization ("predecoding") and TX precoding + layer mapping.

Capability parity with lib/src/phy/mimo/precoding.c and layermap.c:
single-port MRC/MMSE (precoding.c:63-354), 2-port SFBC diversity
(precoding.c:356-686), 2x2 spatial multiplexing MMSE with codebook
rotation and CSI output (precoding.c:1121-1764), TX precoding and layer
map/demap (layermap.c:38-221). Per-RE 2x2 solves are closed-form
elementwise arithmetic over the whole resource grid (mat.c:55-98).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch


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


def eq_mux_2x2(y, h, noise_est=0.0):
    """2x2 spatial multiplexing MMSE (precoding.c:1121-1764, mat.c:63-98).

    y[..., 2, n] rx symbols, h[..., 2rx, 2tx, n] channel ->
    (x[..., 2, n] layer symbols, csi[..., 2, n]); csi_i =
    1 / [(H^H H + N0 I)^-1]_ii weights the LLRs.
    """
    x0, x1, csi0, csi1 = eq_mux_2x2_components(
        y[..., 0, :], y[..., 1, :], h[..., 0, 0, :], h[..., 0, 1, :],
        h[..., 1, 0, :], h[..., 1, 1, :], noise_est)
    return torch.stack([x0, x1], dim=-2), torch.stack([csi0, csi1], dim=-2)


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
    raise NotImplementedError((nof_codewords, nof_layers))


def layerdemap(layers, nof_codewords: int = 1):
    """Layers -> list of codeword symbol tensors: inverse of layermap."""
    n_layers = layers.shape[-2]
    if nof_codewords == 1 and n_layers == 1:
        return [layers[..., 0, :]]
    if nof_codewords == 1 and n_layers == 2:
        x = torch.stack([layers[..., 0, :], layers[..., 1, :]], dim=-1)
        return [x.reshape(*layers.shape[:-2], -1)]
    if nof_codewords == 2 and n_layers == 2:
        return [layers[..., 0, :], layers[..., 1, :]]
    raise NotImplementedError((nof_codewords, n_layers))


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

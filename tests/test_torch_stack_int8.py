"""The JAX package's int8-lane stack scenario on the port's stack, on the
CPU: ``tests/test_int8_lane.py::TestInt8Stack::
test_attach_and_user_plane_on_int8_lane`` with its asserts.

The UE receives every PDSCH on the quantized int8 lane (byte demod
scales, int8 de-rate-matching and softbuffers) and, as in the JAX
package, decodes it in bfloat16 (``TurboDecoder(dtype="auto")``); the
attach and a ping and a pong must get through over an 18 dB air.
"""

import torch

from empower_srslte_tpu_torch.apps.lte_attach import epc as _epc
from empower_srslte_tpu_torch.ops.fec import turbo_nii
from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
from empower_srslte_tpu_torch.upper.gtpu import gtpu_unpack
from empower_srslte_tpu_torch.utils.cell import Cell


def test_attach_and_user_plane_on_int8_lane(monkeypatch):
    """Full OTA attach + both-way user plane with the UE receiving every
    PDSCH on the int8 lane."""
    mme, nas = _epc()
    cell = Cell(nof_prb=25, id=1)
    enb = EnbStack(cell, mme, device="cpu")
    ue = UeStack(cell, nas, llr_int8=True, device="cpu")
    air = Air(cell.sf_sample_len, snr_db=18.0)

    # the decodes' metric dtypes: the UE's int8 PDSCH code blocks with a
    # turbo window run the bfloat16 twin
    dtypes = []
    real = turbo_nii.map_decode_nii

    def spy(u, *a, **kw):
        dtypes.append(u.dtype)
        return real(u, *a, **kw)

    monkeypatch.setattr("empower_srslte_tpu_torch.ops.fec.turbo_decoder."
                        "map_decode_nii", spy)

    ul_iq, attached_at, pushed = None, None, False
    for tti in range(140):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        if attached_at is None and ue.rrc.nas.attached and ue.rrc.drbs:
            attached_at = tti
            ue.send_ip(b"\x45\x00" + bytes(18) + b"PING-OVER-INT8!")
        if attached_at is not None and not pushed and enb.ul_gtpu:
            pushed = True
            pong = (b"\x45\x00" + bytes(14)
                    + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                    + b"PONG-OVER-INT8!")
            fwd = mme.spgw.downlink(pong)
            enb.deliver_gtpu(fwd[1])
        if pushed and ue.rx_ip:
            break

    assert attached_at is not None, (ue.events[-8:], enb.events[-8:])
    assert enb.ul_gtpu and \
        gtpu_unpack(enb.ul_gtpu[0])[1].endswith(b"PING-OVER-INT8!")
    assert ue.rx_ip and ue.rx_ip[0].endswith(b"PONG-OVER-INT8!")
    assert torch.bfloat16 in dtypes

"""PyTorch + CUDA port of the LTE PHY framework: the UE downlink receiver
in every transmission mode (with PHICH, the common search space and the
int8 LLR lane), measurement reporting, cell acquisition, the uplink (PUSCH
with UCI, PUCCH, PRACH, SRS), PMCH/MBSFN, and the eNB/UE/EPC stack on top
of them (``stack/``, with the protocol layers ``mac/``, ``rrc/``,
``upper/``, ``epc/``, ``s1ap/`` copied from the reference, and the entry
point ``python -m empower_srslte_tpu_torch.apps.lte_attach``).

A second package beside the JAX reference (``empower_srslte_tpu``, left
unchanged); it imports torch and numpy and nothing of the reference.
Its layout mirrors the reference's (``utils/``, ``ops/``, ``ops/fec/``,
``models/``, ``tools/``, ``stack/`` and the protocol layers) so each module's counterpart sits at the same
path. Every TPU Pallas kernel of the reference has a hand-written CUDA C++
counterpart for Hopper (sm_90a) under ``csrc/``, built on first use:

  csrc/turbo_nii.cu        <- ops/fec/turbo_decoder_pallas2.py map_decode_nii
                              (wrapper and plain twin: ops/fec/turbo_nii.py)
  csrc/viterbi37.cu        <- ops/fec/viterbi_pallas.py viterbi_regs_pallas
                              (wrapper: ops/fec/viterbi37.py; plain twin:
                              ops/fec/convcoder.py viterbi_decode_plain)
  csrc/turbo_win.cu        <- ops/fec/turbo_decoder_pallas.py map_decode_fused
                              (wrapper and plain twin: ops/fec/turbo_win.py)
  csrc/recursion_probe.cu  <- tools/microbench_vpu.py's probe kernel
                              (wrapper, twin and tool:
                              tools/microbench_recursion.py)

and kernels that replace loops of tiny PyTorch ops on the receive
paths:

  csrc/chest_dl.cu         the CRS channel and pilot noise estimate of
                           every (subframe, rx, port) in one launch
                           (wrapper and plain twins: ops/chest.py)
  csrc/pdcch_rx.cu         the PCFICH and the PDCCH region's LLRs in one
                           launch, the blind search of every candidate
                           and DCI size (rate de-matching, the Viterbi
                           warp code of viterbi37_warp.cuh, CRC16) in
                           another (wrappers and plain twins:
                           models/pdcch.py, models/pcfich.py)

Entry points that create tensors run on the CUDA card unless given
``device="cpu"``; on a CPU tensor a kernel wrapper runs its plain twin.
"""

"""PyTorch + CUDA port of the LTE PHY framework's UE downlink receiver.

A second package beside the JAX reference (``empower_srslte_tpu``, left
unchanged); it imports torch and numpy and nothing of the reference.
Its layout mirrors the reference's (``utils/``, ``ops/``, ``ops/fec/``,
``models/``) so each module's counterpart sits at the same path. The two
TPU Pallas kernels on the receiver's path have hand-written CUDA C++
counterparts for Hopper (sm_90a) under ``csrc/``, built on first use:

  csrc/turbo_nii.cu  <- ops/fec/turbo_decoder_pallas2.py map_decode_nii
                        (wrapper and plain twin: ops/fec/turbo_nii.py)
  csrc/viterbi37.cu  <- ops/fec/viterbi_pallas.py viterbi_regs_pallas
                        (wrapper: ops/fec/viterbi37.py; plain twin:
                        ops/fec/convcoder.py viterbi_decode_plain)

Entry points that create tensors run on the CUDA card unless given
``device="cpu"``; on a CPU tensor a kernel wrapper runs its plain twin.
"""

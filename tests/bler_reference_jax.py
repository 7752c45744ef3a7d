"""BLER of the JAX package's default kernel decode on the CPU, for the
port's sweep to be read against (not a test; pytest does not collect it).

    JAX_PLATFORMS=cpu python tests/bler_reference_jax.py [cbs] [dB,dB,...]

The JAX ``TurboDecoder`` with ``impl="pallas2_interpret"`` and
``dtype="bfloat16"`` (the NII Pallas kernel in interpret mode, in the
precision its ``"auto"`` gives on its accelerator), beside its float32
XLA decoder, on ``tools/bler_sweep.py``'s setup: K 1024, 6 iterations
without early stop, window 128, float32 LLRs from ``default_rng(0)``.
Defaults: 512 code blocks at 0.8, 1.0 and 1.2 dB. Prints one JSON line.
"""

import json
import os
import sys
import time

os.environ.setdefault("TURBO_SUB", "8")
os.environ.setdefault("TURBO_LANES", "64")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np  # noqa

K, ITERATIONS, WINDOW = 1024, 6, 128


def main(argv) -> int:
    cbs = int(argv[0]) if argv else 512
    points = ([float(x) for x in argv[1].split(",")] if len(argv) > 1
              else [0.8, 1.0, 1.2])
    decoders = {
        "pallas2_interpret_bfloat16": TurboDecoder(
            k=K, iterations=ITERATIONS, window=WINDOW,
            impl="pallas2_interpret", dtype="bfloat16"),
        "xla_float32": TurboDecoder(k=K, iterations=ITERATIONS,
                                    window=WINDOW, impl="xla",
                                    dtype="float32")}
    runs = {name: jax.jit(dec.decode) for name, dec in decoders.items()}
    rng = np.random.default_rng(0)
    out = {"k": K, "iterations": ITERATIONS, "window": WINDOW, "cbs": cbs,
           "points": points, "backend": jax.default_backend(),
           "bler": {n: [] for n in runs}, "ber": {n: [] for n in runs}}
    t0 = time.perf_counter()
    for ebn0_db in points:
        u = rng.integers(0, 2, size=(cbs, K)).astype(np.int8)
        d = turbo_encode_np(u)
        n0 = 1.0 / (10 ** (ebn0_db / 10) / 3)
        y = 1 - 2 * d.astype(np.float64) + np.sqrt(n0 / 2) * rng.normal(
            size=d.shape)
        llr = jnp.asarray((4 / n0 * y).astype(np.float32))
        for name, run in runs.items():
            errs = np.asarray(run(llr)[0]) != u
            out["bler"][name].append(float(errs.any(axis=1).mean()))
            out["ber"][name].append(float(errs.mean()))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

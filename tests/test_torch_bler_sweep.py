"""The port's BLER sweep tool (``empower_srslte_tpu_torch/tools/
bler_sweep.py``) on the CPU at a small size: 2 Eb/N0 points x 16 code
blocks of K 256, every curve (2 decoders x 2 metric dtypes x 2 LLR
lanes). Checks the printed format, the JSON result and its gate, and that
the tool imports nothing of JAX. Its BLERs at this size mean nothing; the
gate runs on the card (``chip_smoke.py`` phase ``bler_gate``)."""

import ast
import json
import pathlib

from empower_srslte_tpu_torch.tools import bler_sweep


def test_sweep_prints_every_curve_and_a_gate(capsys):
    assert bler_sweep.main(["--cpu", "--k", "256", "--cbs", "16",
                            "--points", "1.0,1.2", "--seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(lines[-1])
    assert res["k"] == 256 and res["cbs"] == 16 and res["window"] == 128
    assert res["points"] == [1.0, 1.2] and res["device"] == "cpu"
    assert len(res["curves"]) == 8
    assert {(c["impl"], c["dtype"], c["llr"]) for c in res["curves"]} == {
        (i, d, n) for i in bler_sweep.IMPLS for d in bler_sweep.DTYPES
        for n in bler_sweep.LANES}
    for c in res["curves"]:
        assert len(c["bler"]) == len(c["ber"]) == 2
        assert all(0.0 <= v <= 1.0 for v in c["bler"] + c["ber"])
    heads = [ln for ln in lines if ln.startswith("# K=256")]
    assert len(heads) == 8 and "16 CB/point" in heads[0]
    rows = [ln.split() for ln in lines[:-1] if not ln.startswith("#")]
    assert len(rows) == 16 and all(len(r) == 3 for r in rows)
    assert {float(r[0]) for r in rows} == {1.0, 1.2}
    gate = res["gate"]
    assert set(gate) == {"ok", "checks", "comparisons"}
    # per decoder and lane one shift check (here 1.1 dB is not on the
    # grid, so nothing is compared), per curve the two ceilings
    assert len(gate["checks"]) == 4 + 8 * 2
    assert gate["comparisons"] == []


def test_gate_reads_the_shifted_float32_point():
    """A bfloat16 curve less than 0.1 dB to the right of its float32
    curve passes; one further right fails, by the 3-sigma binomial rule,
    while every ceiling still holds."""
    pts = [0.9, 1.0, 1.1, 1.2]
    f32 = [0.5, 0.2, 0.03, 0.0]

    def res(b16):
        curves = []
        for impl in bler_sweep.IMPLS:
            for lane in bler_sweep.LANES:
                curves += [{"impl": impl, "dtype": "float32", "llr": lane,
                            "bler": f32, "ber": f32},
                           {"impl": impl, "dtype": "bfloat16", "llr": lane,
                            "bler": b16, "ber": b16}]
        return {"cbs": 4096, "points": pts, "curves": curves}

    ok = bler_sweep.gate(res([0.9, 0.3, 0.1, 0.02]))
    assert ok["ok"], ok["checks"]
    assert len(ok["comparisons"]) == 4 * 3
    bad = bler_sweep.gate(res([0.9, 0.35, 0.3, 0.04]))
    assert not bad["ok"]
    assert [k for k, v in bad["checks"].items() if not v] == [
        f"{i}_{n}_bf16_within_0.1db" for i in bler_sweep.IMPLS
        for n in bler_sweep.LANES]


def test_tool_imports_nothing_of_jax():
    tree = ast.parse(pathlib.Path(bler_sweep.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "empower_srslte_tpu")]

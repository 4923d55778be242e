"""The port's ports of the reference's examples (`repro_torch.examples`).

`cost_model_explore` prints what the reference's example prints, line for
line (the same cost model over the same spec).  `serve_batch` serves its
six requests on the CPU, for the default arch and for dbrx (MoE), with the
reference example's prompts (the same numpy draws) and stats.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from repro_torch.examples import cost_model_explore, serve_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cost_model_explore_prints_the_references_lines(capsys):
    _reference_example("cost_model_explore").main()
    want = capsys.readouterr().out
    cost_model_explore.main()
    got = capsys.readouterr().out
    assert got == want
    assert "MoE dispatch ->" in got


@pytest.mark.parametrize("arch", ["stablelm_12b", "dbrx_132b"])
def test_serve_batch_on_the_cpu(arch, capsys):
    serve_batch.main(["--device", "cpu", "--arch", arch])
    lines = capsys.readouterr().out.splitlines()
    stats = json.loads("\n".join(lines[:-3]))
    assert set(stats) == {"requests", "tokens", "wall_s", "tok_per_s",
                          "completed"}
    assert stats["requests"] == stats["completed"] == 6
    assert stats["tokens"] == 6 * 5      # the first token comes at prefill
    rng = np.random.default_rng(1)
    lens = []
    for _ in range(6):
        lens.append(int(rng.integers(3, 20)))
        rng.integers(0, 256, lens[-1])
    for i, line in enumerate(lines[-3:]):
        assert line.startswith(f"req {i}: prompt[{lens[i]}] -> [")
        assert len(json.loads(line.split(" -> ")[1])) == 6

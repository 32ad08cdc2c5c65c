"""The port's ``scenarios`` subcommand against the JAX package's, on the
CPU, as processes: on the echo executor it prints one summary line with
JAX's keys and counts and writes the report; it exits with JAX's codes
for scenarios disabled with no names (2) and an unknown name (1); the
``scenarios`` block names, scales and reports its runs; and without
``--device`` or ``--backend`` it builds the configured model on
``cuda`` (tolerance: none). Each process has a time limit of its own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


SUMMARY_KEYS = {"scenario", "scale", "goodput_tps", "slo_attainment",
                "completed", "failed", "shed", "chaos_events_fired",
                "engine_recoveries", "invariant_violations", "report_path"}


def _cli(tmp_path, pkg, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("LLMQ_CONFIG", None)
    return subprocess.run([sys.executable, "-m", pkg, *args],
                          capture_output=True, text=True, timeout=240,
                          cwd=tmp_path, env=env)


def test_cli_runs_a_scenario_on_echo_like_jax(tmp_path):
    """``--backend echo --device cpu scenarios agentic_tool_loops --scale
    0.05`` exits 0 with one summary line holding JAX's keys and counts,
    and writes the report (JAX's CLI on its echo default, side by side)."""
    lines = {}
    for pkg, extra in (("llmq_tpu", ()),
                       ("llmq_tpu_torch", ("--backend", "echo",
                                           "--device", "cpu"))):
        d = tmp_path / pkg
        d.mkdir()
        res = _cli(d, pkg, *extra, "scenarios", "agentic_tool_loops",
                   "--scale", "0.05")
        assert res.returncode == 0, res.stdout + res.stderr
        summary = [json.loads(x) for x in res.stdout.splitlines()
                   if x.startswith('{"scenario"')]
        assert len(summary) == 1, res.stdout
        lines[pkg] = summary[0]
        assert (d / "SCENARIO_agentic_tool_loops.json").is_file()
    j, t = lines["llmq_tpu"], lines["llmq_tpu_torch"]
    assert set(t) == set(j) == SUMMARY_KEYS
    for k in ("scenario", "scale", "completed", "failed", "shed",
              "chaos_events_fired", "engine_recoveries",
              "invariant_violations", "slo_attainment"):
        assert t[k] == j[k], k
    assert t["completed"] == 78 and t["goodput_tps"] > 0


@pytest.mark.parametrize("args,rc", [
    (("scenarios",), 2),                   # disabled, no names
    (("scenarios", "no_such_scenario"), 1),
])
def test_cli_exit_codes_like_jax(tmp_path, args, rc):
    """The same exit code as JAX's CLI: 2 for scenarios disabled with no
    names, 1 for an unknown name."""
    got = {}
    for pkg, extra in (("llmq_tpu", ()),
                       ("llmq_tpu_torch", ("--backend", "echo",
                                           "--device", "cpu"))):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _cli(d, pkg, *extra, *args).returncode
    assert got == {"llmq_tpu": rc, "llmq_tpu_torch": rc}


def test_cli_engine_runs_on_cuda_unless_told(tmp_path):
    """Without ``--device`` or ``--backend`` the subcommand builds the
    configured model on ``cuda``: on a host without a card the run fails
    (exit 1, the builder's reason logged) and nothing falls back to the
    CPU or to echo."""
    res = _cli(tmp_path, "llmq_tpu_torch", "--config", os.devnull,
               "--model", "llama3-tiny", "scenarios", "agentic_tool_loops",
               "--scale", "0.05")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "CUDA is not available" in res.stdout + res.stderr
    assert '{"scenario"' not in res.stdout


def test_scenarios_block_drives_the_cli(tmp_path):
    """``scenarios.run`` names the runs of a bare ``scenarios`` command,
    ``scenarios.scale`` scales them and ``scenarios.emit_json: false``
    writes no report (JAX's CLI gives the same line: rag at 0.05 is 14
    turns, ``test_torch_scenarios.py::test_echo_report_equals_jaxs``)."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text("scenarios: {run: [rag_long_prompt_flood], scale: 0.05,"
                   " emit_json: false}\n")
    res = _cli(tmp_path, "llmq_tpu_torch", "--config", str(cfg),
               "--backend", "echo", "--device", "cpu", "scenarios")
    assert res.returncode == 0, res.stdout + res.stderr
    s = [json.loads(x) for x in res.stdout.splitlines()
         if x.startswith('{"scenario"')]
    assert [(x["scenario"], x["scale"], x["completed"], x["report_path"])
            for x in s] == [("rag_long_prompt_flood", 0.05, 14, None)]
    assert not list(tmp_path.glob("SCENARIO_*.json"))

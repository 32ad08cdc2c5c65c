"""Multi-process bring-up of the port (``parallel.distributed_init``,
``__main__._maybe_join_cluster``), against ``tests/test_distributed.py``:
two OS processes rendezvous on a local coordinator over gloo and run
``all_reduce`` and ``all_gather``, a second ``distributed_init`` is a
no-op, a bad coordinator fails fast (it raises, never swallows), two
``python -m llmq_tpu_torch gateway`` processes with ``LLMQ_COORDINATOR``
join one world and both answer ``/health``, a partial set of variables
refuses to start, a ``serve`` mesh of two ranks serves through rank 0
while rank 1 follows and stops with it, ``scenarios`` runs two scenarios
over one such mesh, a follower whose driver is killed exits non-zero
within its timeout, and a follower whose own call fails leaves at once,
so its driver fails fast instead of waiting out the timeout. Every
spawned process imports only the port, takes a free port and has a
timeout of at most 120 s."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = os.path.join(REPO, "tests", "torch_mesh_rank.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "LLMQ_"))
           and k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _finish(procs, timeout=60):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from llmq_tpu_torch.parallel import distributed_init, make_mesh

distributed_init({coord!r}, 2, {pid}, 60, device="cpu")
# A second call is a no-op.
distributed_init({coord!r}, 2, {pid}, 60, device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == {pid}
x = torch.tensor([float({pid} + 1)])
dist.all_reduce(x)
assert float(x) == 3.0, x
got = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
dist.all_gather(got, torch.tensor([{pid}]))
assert sorted(int(t) for t in got) == [0, 1], got
mesh = make_mesh({{"tp": -1}})
assert mesh.shape == {{"tp": 2}} and mesh.rank == {pid}
assert mesh.backend == "gloo" and mesh.group is not None
assert "jax" not in sys.modules and "llmq_tpu" not in sys.modules
dist.barrier()      # leave together: neither tears down mid-exchange
dist.destroy_process_group()
print("proc {pid} OK", flush=True)
"""


def _port_taken(outs) -> bool:
    """Whether a rank failed because the coordinator's port, free when
    the test picked it, was bound meanwhile by another process (a
    parallel test's ranks bind ephemeral ports too)."""
    return any("EADDRINUSE" in out or "ddress already in use" in out
               for out in outs)


def test_two_process_rendezvous_and_collective():
    for _attempt in range(3):
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(repo=REPO, coord=coord,
                                                  pid=pid)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in range(2)]
        outs = _finish(procs, timeout=55)
        if not _port_taken(outs):
            break
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


def test_bad_coordinator_fails_fast():
    """A dead coordinator raises out of ``distributed_init`` within its
    timeout (never swallowed into a one-process run)."""
    script = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from llmq_tpu_torch.parallel import distributed_init\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        "    distributed_init('127.0.0.1:1', 2, 1, 2, device='cpu')\n"
        "except Exception as e:\n"
        "    print('RAISED', round(time.monotonic() - t0, 1), type(e).__name__,"
        " flush=True); raise SystemExit(0)\n"
        "print('SWALLOWED', flush=True); raise SystemExit(1)\n")
    p = subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, text=True, timeout=90)
    out = p.stdout + p.stderr
    assert "SWALLOWED" not in out, out
    assert p.returncode == 0 and "RAISED" in out, out
    assert float(out.split("RAISED")[1].split()[0]) < 60, out


def _health(port: int) -> bool:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=2):
            return True
    except OSError:
        return False


def _cluster_env(coord_port: int, pid: int, n: int = 2, **extra):
    return _env(LLMQ_COORDINATOR=f"127.0.0.1:{coord_port}",
                LLMQ_NUM_PROCESSES=str(n), LLMQ_PROCESS_ID=str(pid),
                LLMQ_CLUSTER_TIMEOUT="60", **extra)


def test_serve_entrypoints_join_cluster(tmp_path):
    """Two gateways with the LLMQ_COORDINATOR variables join one world
    (each logs its rank) and both serve HTTP."""
    coord_port = _free_port()
    ports = [_free_port() for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(ports[pid]), "gateway"],
        env=_cluster_env(coord_port, pid), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(map(_health, ports)):
            time.sleep(0.2)
        assert all(map(_health, ports)), "gateways did not come up"
    finally:
        for p in procs:
            p.terminate()
        outs = _finish(procs, timeout=30)
    for pid, out in enumerate(outs):
        assert (f"torch.distributed initialised: process {pid} of 2 (gloo)"
                in out), out


def test_partial_cluster_variables_refuse_to_start(tmp_path):
    env = _env(LLMQ_COORDINATOR=f"127.0.0.1:{_free_port()}",
               LLMQ_PROCESS_ID="0")
    p = subprocess.run(
        [sys.executable, "-m", "llmq_tpu_torch", "--device", "cpu",
         "gateway"], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=60)
    assert p.returncode != 0
    assert "LLMQ_NUM_PROCESSES" in p.stderr and "all three" in p.stderr, (
        p.stderr)


def test_serve_mesh_rank0_serves_rank1_follows(tmp_path):
    """``serve`` over a ``{"tp": 2}`` mesh of two processes: rank 0 runs
    the App and answers REST; rank 1 builds only its executor shard and
    follows (it opens no port); SIGTERM on rank 0 drains, releases the
    mesh, and rank 1 exits 0 at the stop."""
    cfg = tmp_path / "mesh.yaml"
    cfg.write_text("model: {name: llama3-tiny, max_seq_len: 256}\n"
                   "executor: {max_batch_size: 2, kv_pages: 33, "
                   "decode_chunk: 2, prefill_buckets: [32],\n"
                   "           mesh: {enabled: true, shape: {tp: 2}}}\n")
    coord_port, port = _free_port(), _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "serve"], env=_cluster_env(coord_port, pid), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and not _health(port):
            assert procs[0].poll() is None, procs[0].communicate()[0]
            time.sleep(0.2)
        body = json.dumps({"content": "hello mesh", "priority": "normal",
                           "metadata": {"max_new_tokens": 4}}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/generate", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["usage"]["completion_tokens"] > 0, out
        procs[0].send_signal(signal.SIGTERM)
        outs = _finish(procs, timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 0, outs[0]
    assert procs[1].returncode == 0, outs[1]
    assert "following on cpu" in outs[1], outs[1]
    assert "the driver released the mesh" in outs[1], outs[1]


_TINY = dict(dim=64, n_heads=4, n_kv_heads=4, ffn_dim=128, vocab_size=300,
             max_seq_len=64)


def _tiny_weights(tmp_path) -> str:
    """A tiny float32 tree from seed 0, saved flat for the rank script."""
    import numpy as np
    import torch

    from llmq_tpu_torch.models.llama import init_params, llama3_tiny

    params = init_params(llama3_tiny(dtype=torch.float32, **_TINY),
                         torch.Generator().manual_seed(0), "cpu")
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                flat[pre + k] = v.numpy()
    walk(params)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **flat)
    return weights


def _spawn_ranks(tmp_path, variant, out, timeout):
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for r in range(2):
        spec = tmp_path / f"rank{r}.json"
        spec.write_text(json.dumps({
            "coord": coord, "world": 2, "rank": r, "out": out,
            "timeout": timeout, "variants": [variant]}))
        procs.append(subprocess.Popen(
            [sys.executable, RANK, str(spec)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def test_follower_exits_nonzero_when_its_driver_dies(tmp_path):
    """Rank 0 is SIGKILLed while its follower waits for the next call:
    the follower raises out of its loop (the driver's connection closes,
    or the group's timeout passes) and exits non-zero, well inside the
    timeout, never hanging."""
    out = str(tmp_path / "ready.json")
    timeout = 20
    procs = _spawn_ranks(tmp_path, {
        "kind": "idle", "cfg": _TINY, "weights": _tiny_weights(tmp_path),
        "geometry": {"batch_size": 2, "num_pages": 9,
                     "prefill_buckets": [16]}}, out, timeout)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not os.path.exists(out):
            assert procs[0].poll() is None, procs[0].communicate()[0]
            time.sleep(0.1)
        assert os.path.exists(out)
        procs[0].kill()
        t0 = time.monotonic()
        rc = procs[1].wait(timeout=timeout + 30)
        waited = time.monotonic() - t0
    finally:
        outs = _finish(procs, timeout=10)
    assert rc == 3, outs[1]
    assert "left the mesh" in outs[1], outs[1]
    assert waited < timeout + 10, waited


def test_follower_whose_call_fails_leaves_and_its_driver_fails_fast(
        tmp_path):
    """Rank 1's decode step raises while rank 0's runs: rank 1 leaves the
    mesh at once (exit 3, naming the call), and rank 0, waiting in a
    collective rank 1 skipped, fails on the closed peer far inside the
    mesh's 60 s timeout instead of waiting it out."""
    out = str(tmp_path / "broken.json")
    timeout = 60
    procs = _spawn_ranks(tmp_path, {
        "kind": "broken", "broken_rank": 1, "cfg": _TINY,
        "weights": _tiny_weights(tmp_path),
        "geometry": {"batch_size": 2, "num_pages": 9, "chunk_size": 2,
                     "prefill_buckets": [16]},
        "reqs": [{"id": "a", "prompt": "hello", "max_new_tokens": 4}]},
        out, timeout)
    outs = _finish(procs, timeout=110)
    assert procs[1].returncode == 3, outs[1]
    assert "left the mesh: mirrored" in outs[1], outs[1]
    assert "failed on rank 1" in outs[1], outs[1]
    assert procs[0].returncode == 0, outs[0]
    with open(out) as f:
        (got,) = json.load(f)
    failed = got["error"] is not None or any(
        r["finish_reason"] == "error" for r in got["reqs"])
    assert failed, got
    assert got["seconds"] < timeout / 2, got


def test_scenarios_run_twice_over_one_mesh(tmp_path):
    """``scenarios a b`` over a ``{"tp": 2}`` mesh of two processes: rank
    0 builds one executor for both runs (rank 1 follows that one), both
    runs complete every turn, and rank 1 stops with the last run."""
    scn = tmp_path / "scn"
    scn.mkdir()
    for name, seed in (("tiny_a", 11), ("tiny_b", 12)):
        (scn / f"{name}.yaml").write_text(
            f"name: {name}\nseed: {seed}\ntick_s: 0.25\nphases:\n"
            "  - {name: p, duration_s: 1.0, "
            "arrival: {kind: poisson, rate: 3.0}}\n"
            "populations:\n"
            "  - {name: u, tenants: {t: 1.0}, priority: normal,\n"
            "     turns_min: 1, turns_max: 2, think_time_s: 0.1,\n"
            "     prompt_tokens_min: 8, prompt_tokens_max: 16,\n"
            "     followup_tokens_min: 4, followup_tokens_max: 8,\n"
            "     output_tokens_min: 2, output_tokens_max: 4}\n")
    cfg = tmp_path / "mesh.yaml"
    cfg.write_text("model: {name: llama3-tiny, max_seq_len: 256}\n"
                   "executor: {max_batch_size: 2, kv_pages: 33, "
                   "decode_chunk: 2, prefill_buckets: [32],\n"
                   "           mesh: {enabled: true, shape: {tp: 2}}}\n"
                   f"scenarios: {{dir: {str(scn)!r}, emit_json: false}}\n")
    coord_port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "scenarios", "tiny_a", "tiny_b"],
        env=_cluster_env(coord_port, pid), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = _finish(procs, timeout=110)
    assert procs[0].returncode == 0, outs[0]
    assert procs[1].returncode == 0, outs[1]
    lines = [json.loads(x) for x in outs[0].splitlines()
             if x.startswith('{"scenario"')]
    assert [x["scenario"] for x in lines] == ["tiny_a", "tiny_b"], outs[0]
    for x in lines:
        assert x["completed"] > 0 and x["failed"] == 0, x
        assert x["invariant_violations"] == 0, x
    assert "following on cpu" in outs[1], outs[1]
    assert "the driver released the mesh" in outs[1], outs[1]
    assert "not held here" not in outs[1], outs[1]


@pytest.mark.parametrize("world", [1])
def test_one_rank_world_is_its_own_driver(world):
    """A world of one (the card's NCCL case, here over gloo): the mesh has
    its group, rank 0 drives, and nothing is broadcast."""
    script = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch.distributed as dist\n"
        "from llmq_tpu_torch.parallel import distributed_init, make_mesh\n"
        f"distributed_init('127.0.0.1:{_free_port()}', {world}, 0, 30,"
        " device='cpu')\n"
        "m = make_mesh({'tp': 1})\n"
        "assert m.group is not None and m.is_driver and m.size == 1\n"
        "dist.destroy_process_group()\n"
        "print('OK', flush=True)\n")
    p = subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0 and "OK" in p.stdout, p.stdout + p.stderr

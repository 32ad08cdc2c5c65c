"""Replica pools: the control plane's provision seam (the port's copy of
``llmq_tpu/controlplane/pool.py``).

The controller decides that a replica is added or removed; a
:class:`ReplicaPool` knows how.

- ``provision(seq)`` brings a replica up and returns a ready
  :class:`Endpoint` for it (the controller registers it), or None when
  the pool cannot. Pool endpoints carry ``metadata["pool"] = True``: the
  controller decommissions only what it provisioned, never a static peer
  or the process's own engine.
- ``decommission(endpoint)`` tears the replica down. The controller
  drains a scale-down victim first, so a pool never reasons about live
  traffic.

:class:`LocalEnginePool` builds engines in this process from a factory,
each under its own :class:`EngineSupervisor`. :class:`SubprocessReplicaPool`
spawns ``python -m llmq_tpu_torch serve`` processes on this host (replica
N on ``base_port + N``) and drains them by SIGTERM. :class:`ExecReplicaPool`
runs shell commands (the compose or Kubernetes hook).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from llmq_tpu_torch.core.config import ReplicaPoolConfig, SupervisorConfig
from llmq_tpu_torch.loadbalancer.load_balancer import Endpoint

log = logging.getLogger("llmq_tpu_torch.controlplane.pool")


def _wait_ready(url: str, timeout: float) -> Optional[Dict[str, Any]]:
    """Poll ``{url}/health`` until it answers 200 (a returned endpoint is
    dispatchable at once: one registered while its replica boots would
    trip its breaker and be declared dead). Returns the parsed body
    (``{}`` when unparseable), or None at the timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"{url}/health",
                                        timeout=1.0) as resp:
                if resp.status == 200:
                    try:
                        body = json.loads(resp.read().decode("utf-8"))
                    except Exception:  # noqa: BLE001 — up; body best-effort
                        body = {}
                    return body if isinstance(body, dict) else {}
        except Exception:  # noqa: BLE001 — still coming up
            pass
        time.sleep(0.1)
    return None


def _adopt_child_boot(replica_id: str, kind: str,
                      health_body: Optional[Dict[str, Any]],
                      total_s: float) -> None:
    """Fold a child's /health ``boot`` block into this process's boot
    registry. A no-op with the critical-path plane off."""
    from llmq_tpu_torch.observability import critical_path as _cp
    if not _cp.cp_enabled():
        return
    boot = (health_body or {}).get("boot") or {}
    stages = boot.get("stages_s") or {}
    try:
        _cp.get_boot_registry().adopt(replica_id, kind, stages,
                                      total_s=total_s)
    except Exception:  # noqa: BLE001 — telemetry must not fail provision
        log.exception("boot adoption failed for %s", replica_id)


class ReplicaPool:
    """The contract (see the module docstring)."""

    kind = "base"

    #: The disaggregation role the next provision gives its replica (set
    #: by the controller just before ``provision``); None: no preference.
    #: Process pools export it to the child as ``LLMQ_DISAGG_ROLE``.
    role_hint: Optional[str] = None

    def provision(self, seq: int) -> Optional[Endpoint]:
        raise NotImplementedError

    def decommission(self, endpoint: Endpoint) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        """Tear down every replica the pool still owns."""

    def get_stats(self) -> Dict[str, Any]:
        return {"kind": self.kind}


class LocalEnginePool(ReplicaPool):
    """Engines in this process from ``engine_factory(seq)`` (None
    refuses). Each gets its own crash supervisor by default, so a
    replica that crash-loops fails out of rotation (the load balancer's
    probe reads ``engine.healthy()``) and the controller replaces it."""

    kind = "local"

    def __init__(self, engine_factory: Callable[[int], Any], *,
                 supervise: bool = True,
                 supervisor_config: Optional[SupervisorConfig] = None,
                 enable_metrics: bool = False) -> None:
        self._factory = engine_factory
        self._supervise = supervise
        self._supervisor_config = (supervisor_config
                                   or SupervisorConfig(check_interval=0.1))
        self._enable_metrics = enable_metrics
        self._mu = threading.Lock()
        self._engines: Dict[str, Any] = {}
        self._supervisors: Dict[str, Any] = {}
        self.provisioned = 0
        self.decommissioned = 0

    def provision(self, seq: int) -> Optional[Endpoint]:
        from llmq_tpu_torch.observability import critical_path as _cp
        cp = _cp.cp_enabled()
        boot_rid = f"local-{seq}"
        t_boot0 = time.perf_counter()
        if cp:
            # The record opens before the factory runs, so the builder
            # stamps its stages into this replica's record.
            _cp.boot_begin(boot_rid, self.kind, process=True)
        engine = self._factory(seq)
        if engine is None:
            return None
        if not engine.running:
            engine.start()
        if cp:
            wall = time.perf_counter() - t_boot0
            rec = _cp.get_boot_registry().get(boot_rid) or {}
            known = sum(v for k, v in (rec.get("stages_s") or {}).items()
                        if k != "provision")
            _cp.boot_stage(boot_rid, "provision", max(0.0, wall - known))
            _cp.boot_ready(boot_rid, wall)
        sup = None
        if self._supervise:
            from llmq_tpu_torch.engine.supervisor import EngineSupervisor
            sup = EngineSupervisor(engine, config=self._supervisor_config,
                                   enable_metrics=self._enable_metrics)
            sup.start()
        eid = engine.name
        ep = Endpoint(id=eid, name=eid, url=f"local://{eid}",
                      metadata={"engine": engine, "pool": True,
                                "pool_seq": seq, "boot_id": boot_rid})
        with self._mu:
            self._engines[eid] = engine
            if sup is not None:
                self._supervisors[eid] = sup
            self.provisioned += 1
        log.info("pool provisioned local engine %s (seq %d)", eid, seq)
        return ep

    def decommission(self, endpoint: Endpoint) -> None:
        with self._mu:
            engine = self._engines.pop(endpoint.id, None)
            sup = self._supervisors.pop(endpoint.id, None)
            self.decommissioned += 1
        if sup is not None:
            # Before the engine stops: a live supervisor would take the
            # deliberate stop for a crash.
            sup.stop()
        if engine is None:
            return
        if not engine.running:
            # A crashed replica: its in-flight handles fail over to the
            # workers' retry path now, not at their deadlines.
            try:
                engine.recover_after_crash()
            except Exception:  # noqa: BLE001 — teardown goes on
                log.exception("crash recovery during decommission of "
                              "%s failed", endpoint.id)
        engine.stop()
        log.info("pool decommissioned local engine %s", endpoint.id)

    def stop(self) -> None:
        with self._mu:
            eids = list(self._engines)
        for eid in eids:
            self.decommission(Endpoint(id=eid))

    def get_stats(self) -> Dict[str, Any]:
        with self._mu:
            return {"kind": self.kind, "live": len(self._engines),
                    "provisioned": self.provisioned,
                    "decommissioned": self.decommissioned}


class SubprocessReplicaPool(ReplicaPool):
    """``python -m llmq_tpu_torch serve`` replicas on this host. Replica
    N listens on ``base_port + N``; provision waits for its /health (up
    to ``ready_timeout``). Decommission sends SIGTERM (the replica's own
    drain) and kills after ``TERM_GRACE_S``.

    The child inherits the environment (``LLMQ_CONFIG``, exported by the
    CLI when ``--config`` was given, and every ``LLMQ_*`` override), so
    it serves the parent's configuration; a parent built by hand names
    its file in ``args`` (``[--config, path]``). ``log_dir``, when set,
    receives each child's output as ``replica-<port>.log``; ``launcher``
    (``seq -> argv``) replaces the command before the replica's arguments,
    ``python -m llmq_tpu_torch`` (a harness wraps the module in it)."""

    kind = "subprocess"

    TERM_GRACE_S = 10.0

    def __init__(self, config: ReplicaPoolConfig, *,
                 log_dir: Optional[str] = None,
                 launcher: Optional[Callable[[int], List[str]]] = None
                 ) -> None:
        self.config = config
        self.log_dir = log_dir
        self.launcher = launcher
        self._mu = threading.Lock()
        self._procs: Dict[str, subprocess.Popen] = {}
        self.provisioned = 0
        self.decommissioned = 0

    def provision(self, seq: int) -> Optional[Endpoint]:
        port = int(self.config.base_port) + int(seq)
        url = f"http://127.0.0.1:{port}"
        head = (self.launcher(seq) if self.launcher is not None
                else [sys.executable, "-m", "llmq_tpu_torch"])
        cmd = (list(head) + ["--host", "127.0.0.1", "--port", str(port)]
               + [str(a) for a in (self.config.args or [])]
               + ["serve"])
        env = dict(os.environ)
        # A provisioned replica routes to no peers and provisions nothing
        # itself ("[]" overrides a peer list in the file too).
        env["LLMQ_CLUSTER_PEERS"] = "[]"
        env["LLMQ_CONTROLPLANE_ENABLED"] = "false"
        if self.role_hint:
            env["LLMQ_DISAGG_ROLE"] = str(self.role_hint)
        out = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, f"replica-{port}.log"),
                       "ab")
        t_boot0 = time.perf_counter()
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=out,
                                    stderr=subprocess.STDOUT
                                    if self.log_dir else subprocess.DEVNULL)
        except OSError:
            log.exception("replica subprocess spawn failed (seq %d)", seq)
            return None
        finally:
            if out is not subprocess.DEVNULL:
                out.close()
        health = _wait_ready(url, float(self.config.ready_timeout))
        if health is None or proc.poll() is not None:
            log.error("replica %s never became ready; killing", url)
            proc.kill()
            proc.wait(timeout=5.0)
            return None
        eid = f"127.0.0.1:{port}"
        _adopt_child_boot(eid, self.kind, health,
                          time.perf_counter() - t_boot0)
        with self._mu:
            self._procs[eid] = proc
            self.provisioned += 1
        log.info("pool provisioned subprocess replica %s (pid %d)",
                 eid, proc.pid)
        return Endpoint(id=eid, name=eid, url=url,
                        metadata={"pool": True, "pool_seq": seq,
                                  "pid": proc.pid})

    def decommission(self, endpoint: Endpoint) -> None:
        with self._mu:
            proc = self._procs.pop(endpoint.id, None)
            self.decommissioned += 1
        if proc is None:
            return
        proc.terminate()               # SIGTERM: the replica drains
        try:
            proc.wait(timeout=self.TERM_GRACE_S)
        except subprocess.TimeoutExpired:
            log.warning("replica %s ignored SIGTERM; killing", endpoint.id)
            proc.kill()
            proc.wait(timeout=5.0)
        log.info("pool decommissioned subprocess replica %s", endpoint.id)

    def pids(self) -> Dict[str, int]:
        """Endpoint id → pid of every live child."""
        with self._mu:
            return {eid: p.pid for eid, p in self._procs.items()}

    def stop(self) -> None:
        with self._mu:
            eids = list(self._procs)
        for eid in eids:
            self.decommission(Endpoint(id=eid))

    def get_stats(self) -> Dict[str, Any]:
        with self._mu:
            return {"kind": self.kind, "live": len(self._procs),
                    "provisioned": self.provisioned,
                    "decommissioned": self.decommissioned}


class ExecReplicaPool(ReplicaPool):
    """Shell out to the real orchestrator. ``provision_cmd`` runs with
    ``LLMQ_REPLICA_SEQ`` set and leaves a serving replica; its URL is
    ``url_template.format(seq=...)`` when set, else the command's last
    stdout line. ``decommission_cmd`` runs with ``LLMQ_REPLICA_SEQ``,
    ``LLMQ_REPLICA_ID`` and ``LLMQ_REPLICA_URL``."""

    kind = "exec"

    def __init__(self, config: ReplicaPoolConfig) -> None:
        self.config = config
        self._mu = threading.Lock()
        self._urls: Dict[str, str] = {}
        self._seqs: Dict[str, int] = {}
        self.provisioned = 0
        self.decommissioned = 0

    def provision(self, seq: int) -> Optional[Endpoint]:
        if not self.config.provision_cmd:
            return None
        t_boot0 = time.perf_counter()
        env = dict(os.environ)
        env["LLMQ_REPLICA_SEQ"] = str(seq)
        if self.role_hint:
            env["LLMQ_DISAGG_ROLE"] = str(self.role_hint)
        try:
            out = subprocess.run(
                self.config.provision_cmd, shell=True, env=env,
                capture_output=True, text=True,
                timeout=float(self.config.ready_timeout))
        except subprocess.TimeoutExpired:
            log.error("provision_cmd timed out (seq %d)", seq)
            return None
        if out.returncode != 0:
            log.error("provision_cmd failed (seq %d, rc %d): %s", seq,
                      out.returncode, out.stderr.strip()[-500:])
            return None
        if self.config.url_template:
            url = self.config.url_template.format(seq=seq)
        else:
            lines = [ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip()]
            url = lines[-1] if lines else ""
        if not url.startswith(("http://", "https://")):
            log.error("provision_cmd yielded no replica URL (seq %d, "
                      "got %r)", seq, url)
            return None
        url = url.rstrip("/")
        eid = url.split("://", 1)[-1]
        # The orchestrator returns long before the replica serves.
        health = _wait_ready(url, float(self.config.ready_timeout))
        if health is None:
            log.error("exec replica %s never became ready; running "
                      "decommission_cmd to roll back", url)
            self._run_decommission(seq, eid, url)
            return None
        _adopt_child_boot(eid, self.kind, health,
                          time.perf_counter() - t_boot0)
        with self._mu:
            self._urls[eid] = url
            self._seqs[eid] = seq
            self.provisioned += 1
        log.info("pool provisioned exec replica %s", url)
        return Endpoint(id=eid, name=eid, url=url,
                        metadata={"pool": True, "pool_seq": seq})

    def decommission(self, endpoint: Endpoint) -> None:
        with self._mu:
            url = self._urls.pop(endpoint.id, endpoint.url)
            seq = self._seqs.pop(endpoint.id, -1)
            self.decommissioned += 1
        self._run_decommission(seq, endpoint.id, url or "")

    def _run_decommission(self, seq: int, eid: str, url: str) -> None:
        if not self.config.decommission_cmd:
            return
        env = dict(os.environ)
        env["LLMQ_REPLICA_SEQ"] = str(seq)
        env["LLMQ_REPLICA_ID"] = eid
        env["LLMQ_REPLICA_URL"] = url
        try:
            out = subprocess.run(
                self.config.decommission_cmd, shell=True, env=env,
                capture_output=True, text=True, timeout=60.0)
            if out.returncode != 0:
                log.error("decommission_cmd failed for %s (rc %d): %s",
                          eid, out.returncode, out.stderr.strip()[-500:])
        except subprocess.TimeoutExpired:
            log.error("decommission_cmd timed out for %s", eid)

    def stop(self) -> None:
        with self._mu:
            eids = list(self._urls)
        for eid in eids:
            self.decommission(Endpoint(id=eid))

    def get_stats(self) -> Dict[str, Any]:
        with self._mu:
            return {"kind": self.kind, "live": len(self._urls),
                    "provisioned": self.provisioned,
                    "decommissioned": self.decommissioned}


def build_pool(cfg: ReplicaPoolConfig) -> Optional[ReplicaPool]:
    """The configured pool; None for ``kind: none`` (the controller then
    heals and degrades but never provisions)."""
    if cfg.kind == "subprocess":
        return SubprocessReplicaPool(cfg)
    if cfg.kind == "exec":
        return ExecReplicaPool(cfg)
    return None

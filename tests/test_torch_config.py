"""The port's configuration against the JAX package's: the same YAML file
through both loaders, the keys of the planes the port does not have, and
the file search and its overrides."""

import dataclasses
import os

import pytest

from llmq_tpu.core import config as JC

from llmq_tpu_torch.core import config as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(REPO, "configs", "config.yaml")


def _canonical_for_port(tmp_path, extra=""):
    """configs/config.yaml with only executor.backend changed (the file
    selects echo, which only a named file may), plus ``extra``."""
    text = open(CANONICAL).read()
    assert text.count("  backend: echo ") == 1
    path = tmp_path / "config.yaml"
    path.write_text(text.replace("  backend: echo ", "  backend: torch ")
                    + extra)
    return str(path)


def _port_fields(tobj, jobj, pre=""):
    """(dotted key, port value, JAX value) of every port field the JAX
    package has too."""
    out = []
    for f in dataclasses.fields(tobj):
        if not hasattr(jobj, f.name):
            continue
        tv, jv = getattr(tobj, f.name), getattr(jobj, f.name)
        if dataclasses.is_dataclass(tv):
            out.extend(_port_fields(tv, jv, pre + f.name + "."))
        elif f.name == "levels":
            out.append((pre + f.name, [vars(x) for x in tv],
                        [{k: getattr(y, k) for k in vars(x)}
                         for x, y in zip(tv, jv)]))
        else:
            out.append((pre + f.name, tv, jv))
    return out


def test_canonical_file_loads_alike_in_both_packages(tmp_path):
    """Tolerance: none. Every field the port has takes the JAX package's
    value from the same file."""
    path = _canonical_for_port(tmp_path)
    t = TC.load_config(path, env=False)
    j = JC.load_config(path, env=False)
    pairs = _port_fields(t, j)
    assert len(pairs) > 95
    for key, tv, jv in pairs:
        assert tv == jv, key
    assert len(t.queue.levels) == len(j.queue.levels) == 4


def test_canonical_observability_block_loads_to_jaxs_fields(tmp_path):
    """Tolerance: none. The ``observability`` block of
    configs/config.yaml (with its ``slo``, ``usage`` and
    ``critical_path`` blocks) loads to the JAX package's fields, and the
    defaults are JAX's."""
    path = _canonical_for_port(tmp_path)
    t = TC.load_config(path, env=False).observability
    j = JC.load_config(path, env=False).observability
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(TC.ObservabilityConfig()) == \
        dataclasses.asdict(JC.ObservabilityConfig())
    assert "observability" not in TC._UNPORTED
    env = {"LLMQ_OBSERVABILITY_SLO_WINDOWS_S": "60,600",
           "LLMQ_OBSERVABILITY_USAGE_ENABLED": "false"}
    t = TC.load_config(path, environ=env).observability
    assert t.slo.windows_s == [60.0, 600.0] and t.usage.enabled is False


def test_defaults_equal_jaxs_where_the_blocks_are_new():
    """The blocks this slice adds take the JAX package's defaults, field
    for field of what the port has."""
    t, j = TC.Config(), JC.Config()
    for block in ("scheduler", "resource_scheduler", "loadbalancer",
                  "logging", "metrics"):
        tb, jb = getattr(t, block), getattr(j, block)
        assert vars(tb) == {k: getattr(jb, k) for k in vars(tb)}, block
    assert t.queue.enable_metrics is j.queue.enable_metrics is True
    assert t.cluster.drain_timeout == j.cluster.drain_timeout
    assert [vars(x) for x in t.queue.levels] == \
        [{k: getattr(y, k) for k in vars(x)}
         for x, y in zip(t.queue.levels, j.queue.levels)]
    assert [y.max_concurrent for y in j.queue.levels] == [
        TC._LEVEL_MAX_CONCURRENT[y.priority] for y in j.queue.levels]
    assert JC.QueueLevelConfig().max_concurrent == \
        TC._LEVEL_MAX_CONCURRENT_DEFAULT


def test_unported_table_is_jaxs_tree_at_its_defaults(tmp_path):
    """Tolerance: none. The port's fields and its table of unported keys
    together are the JAX package's key tree, and the table holds the JAX
    package's defaults; ``device`` and ``executor.backend`` aside."""
    jd = dataclasses.asdict(JC.Config())

    def walk(jnode, tobj, table, pre=""):
        for key, jv in jnode.items():
            path = pre + key
            if tobj is not None and any(f.name == key for f in
                                        dataclasses.fields(tobj)):
                tv = getattr(tobj, key)
                if dataclasses.is_dataclass(tv):
                    walk(jv, tv, (table or {}).get(key) or {}, path + ".")
                continue
            assert table is not None and key in table, path
            if isinstance(jv, dict) and jv and not all(
                    isinstance(v, (int, float)) for v in jv.values()):
                walk(jv, None, table[key], path + ".")
            else:
                assert TC._accepts(table[key], jv), path

    walk(jd, TC.Config(), TC._UNPORTED)
    # Endpoint selection is ported: the canonical file's strategy, which
    # differs from the default, loads to JAX's in both packages; only
    # the load balancer's max_retries, which nothing reads, stays.
    j = JC.load_config(CANONICAL, env=False)
    assert TC._UNPORTED["loadbalancer"] == {"max_retries": 3}
    assert TC.load_config(_canonical_for_port(tmp_path), env=False
                          ).loadbalancer.strategy == \
        j.loadbalancer.strategy != JC.Config().loadbalancer.strategy


@pytest.mark.parametrize("snippet,match", [
    ("nope: 1\n", "unknown config key: nope"),
    ("server: {nope: 1}\n", "unknown config key: server.nope"),
    # The disaggregation and control-plane blocks are ported: their cases
    # now hold JAX's validation of each (the ids stay the cases' own).
    pytest.param("disagg: {enabled: true, role: mixed}\n",
                 "unknown disagg role", id="disagg: {enabled: true}\n-"
                                            "disagg.enabled"),
    ("executor: {speculation: {enabled: true, draft_k: 17}}\n",
     "executor.speculation.draft_k"),
    # kv_tiering is ported: the case now holds its validation (the id
    # stays the case's own).
    pytest.param("executor: {kv_tiering: {enabled: true, "
                 "eviction_policy: fifo}}\n",
                 "kv_tiering.eviction_policy",
                 id="executor: {kv_tiering: {enabled: true}}\n-"
                    "executor.kv_tiering.enabled"),
    # The mesh is ported: the case now holds JAX's validation of its
    # shape (the id stays the case's own).
    pytest.param("executor: {mesh: {enabled: true, shape: {zz: 2}}}\n",
                 "executor.mesh.shape axis must be 'dp' or 'tp'",
                 id="executor: {mesh: {enabled: true, shape: {tp: 2}}}\n-"
                    "executor.mesh.enabled"),
    # The echo backend is ported: the case now holds that a backend the
    # port has not ported still raises (the id stays the case's own).
    pytest.param("executor: {backend: tpu}\n", "executor.backend",
                 id="executor: {backend: echo}\n-executor.backend"),
    ("executor: {backend: jax}\n", "executor.backend"),
    # The cluster and scheduler blocks are ported: the cases now hold
    # that an unknown key inside them raises (the ids stay the cases' own).
    pytest.param("cluster: {peers: [http://a:8080], nope: 1}\n",
                 "unknown config key: cluster.nope",
                 id="cluster: {peers: [http://a:8080]}\n-cluster.peers"),
    pytest.param("scheduler: {min_endpoints: 3, nope: 1}\n",
                 "unknown config key: scheduler.nope",
                 id="scheduler: {min_endpoints: 3}\n-scheduler.min_endpoints"),
    # The chaos and store blocks are ported: their cases now hold that
    # an unknown key inside them raises (the ids stay the cases' own).
    pytest.param("chaos: {enabled: true, faults: [{point: engine.step, "
                 "kind: crash}], nope: 1}\n", "unknown config key: chaos.nope",
                 id="chaos: {enabled: true, faults: [{point: engine.step, "
                    "kind: crash}]}\n-chaos.enabled"),
    # tenancy is ported: the case now holds that an unknown key of a
    # tenant class raises (the id stays the case's own).
    pytest.param("tenancy: {enabled: true, tenants: {a: {weight: 2.0, "
                 "nope: 1}}}\n", "unknown config key: tenancy.tenants.a.nope",
                 id="tenancy: {enabled: true}\n-tenancy.enabled"),
    # tpu.mesh_shape is ported (the legacy alias of executor.mesh): the
    # case now holds that an unknown key beside it raises (the id stays
    # the case's own).
    pytest.param("tpu: {mesh_shape: {tp: 8}, nope: 1}\n",
                 "unknown config key: tpu.nope",
                 id="tpu: {mesh_shape: {tp: 8}}\n-tpu.mesh_shape"),
    # The model's weight keys are ported: the case now holds that an
    # unknown key beside them raises (the id stays the case's own).
    pytest.param("model: {checkpoint_path: /ckpt, nope: 1}\n",
                 "unknown config key: model.nope",
                 id="model: {checkpoint_path: /ckpt}\n-model.checkpoint_path"),
    pytest.param("chaos: {enabled: true, faults: [], seeds: 3}\n",
                 "unknown config key: chaos.seeds",
                 id="chaos: {enabled: true, faults: []}\n-chaos.enabled"),
    pytest.param("store: {resilience: {enabled: true, retry: 1}}\n",
                 "unknown config key: store.resilience.retry",
                 id="store: {resilience: {enabled: true}}\n-"
                    "store.resilience.enabled"),
    pytest.param("controlplane: {enabled: true, min_replicas: 2, "
                 "max_replicas: 1}\n", "max_replicas must be >= min_replicas",
                 id="controlplane: {enabled: true}\n-controlplane.enabled"),
    ("disagg: {enabled: false, nope: 1}\n", "unknown config key: disagg.nope"),
    ("loadbalancer: {strategy: fastest}\n", "loadbalancer.strategy"),
    # Endpoint selection and the autoscaler are ported: these cases now
    # hold that an unknown key beside a ported one raises (the ids stay
    # the cases' own).
    pytest.param("loadbalancer: {strategy: least_connections, nope: 1}\n",
                 "unknown config key: loadbalancer.nope",
                 id="loadbalancer: {strategy: least_connections}\n-"
                    "loadbalancer.strategy"),
    pytest.param("loadbalancer: {session_affinity: false, nope: 1}\n",
                 "unknown config key: loadbalancer.nope",
                 id="loadbalancer: {session_affinity: false}\n-"
                    "loadbalancer.session_affinity"),
    ("loadbalancer: {max_retries: 5}\n", "loadbalancer.max_retries"),
    ("scheduler: {strategy: priority_weighted}\n", "scheduler.strategy"),
    pytest.param("scheduler: {cooldown: 5.0, nope: 1}\n",
                 "unknown config key: scheduler.nope",
                 id="scheduler: {cooldown: 5.0}\n-scheduler.cooldown"),
    ("resource_scheduler: {scale_up_load: 0.5}\n",
     "resource_scheduler.scale_up_load"),
    ("server: {read_timeout: 5.0}\n", "server.read_timeout"),
    ("metrics: {port: 9100}\n", "metrics.port"),
    ("queue: {levels: [{priority: 1, max_concurrent: 7}]}\n",
     "queue.levels.max_concurrent"),
    ("executor: {async_pipeline: {depth: 9}}\n", "depth"),
    ("server: 8080\n", "must be a mapping"),
])
def test_unknown_keys_and_unported_planes_raise(tmp_path, snippet, match):
    path = tmp_path / "c.yaml"
    path.write_text(snippet)
    with pytest.raises(ValueError, match=match):
        TC.load_config(str(path), env=False)


@pytest.mark.parametrize("snippet", [
    "disagg: {enabled: false, role: prefill}\n",
    "executor: {speculation: {enabled: false, draft_k: 8}}\n",
    "tenancy: {enabled: false, share_window_s: 30.0}\n",
    "cluster: {peers: [], drain_timeout: 5.0}\n",
    "model: {dtype: bfloat16}\n",
    "executor: {mesh: {enabled: false, shape: {}}}\n",
    "loadbalancer: {strategy: round_robin}\n",
    "loadbalancer: {strategy: adaptive_load, session_ttl: 1800.0}\n",
    "queue: {levels: [{priority: 1, max_concurrent: 100}, "
    "{priority: 2, max_concurrent: 500}, {priority: 4}]}\n",
    "metrics: {enabled: false, port: 9090, path: /metrics}\n",
])
def test_unported_planes_off_or_at_default_are_accepted(tmp_path, snippet):
    path = tmp_path / "c.yaml"
    path.write_text(snippet)
    cfg = TC.load_config(str(path), env=False)
    JC.load_config(str(path), env=False)      # JAX's loader takes it too
    assert cfg.executor.backend == "torch"


@pytest.mark.parametrize("source", ["file", "env"])
def test_wal_and_spool_dirs_load_like_jaxs(tmp_path, source):
    """Tolerance: none. ``queue.wal_dir`` and ``queue.spool_dir`` are
    real fields with the JAX package's defaults (""), and load to the
    same values from a file and from ``LLMQ_QUEUE_WAL_DIR`` /
    ``LLMQ_QUEUE_SPOOL_DIR`` in both packages."""
    assert (TC.QueueConfig().wal_dir, TC.QueueConfig().spool_dir) == (
        JC.QueueConfig().wal_dir, JC.QueueConfig().spool_dir) == ("", "")
    assert "queue" not in TC._UNPORTED
    wal, spool = str(tmp_path / "wal"), str(tmp_path / "spool")
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text(f"queue: {{wal_dir: {wal}, spool_dir: {spool}}}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_QUEUE_WAL_DIR": wal, "LLMQ_QUEUE_SPOOL_DIR": spool}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert (t.queue.wal_dir, t.queue.spool_dir) == (
        j.queue.wal_dir, j.queue.spool_dir) == (wal, spool)


@pytest.mark.parametrize("source", ["file", "env"])
def test_speculation_block_loads_like_jaxs(tmp_path, source):
    """Tolerance: none. ``executor.speculation`` is a real block with the
    JAX package's fields and defaults; the same file and the same
    ``LLMQ_EXECUTOR_SPECULATION_*`` variables load to the same values in
    both packages, and the same bad values raise the same errors."""
    assert dataclasses.asdict(TC.SpeculationConfig()) == \
        dataclasses.asdict(JC.SpeculationConfig())
    assert "speculation" not in TC._UNPORTED["executor"]
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text("executor: {speculation: {enabled: true, draft_k: 6, "
                        "ngram_max: 2, device_sampling: false}}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_EXECUTOR_SPECULATION_ENABLED": "true",
               "LLMQ_EXECUTOR_SPECULATION_DRAFT_K": "6",
               "LLMQ_EXECUTOR_SPECULATION_NGRAM_MAX": "2",
               "LLMQ_EXECUTOR_SPECULATION_DEVICE_SAMPLING": "false"}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert dataclasses.asdict(t.executor.speculation) == \
        dataclasses.asdict(j.executor.speculation) == {
            "enabled": True, "draft_k": 6, "ngram_max": 2,
            "device_sampling": False}
    for bad in ({"draft_k": 0}, {"draft_k": 17}, {"ngram_max": 0}):
        with pytest.raises(ValueError) as te:
            TC.SpeculationConfig(**bad)
        with pytest.raises(ValueError) as je:
            JC.SpeculationConfig(**bad)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("source", ["file", "env"])
def test_kv_tiering_block_loads_like_jaxs(tmp_path, source):
    """Tolerance: none. ``executor.kv_tiering`` is a real block with the
    JAX package's fields and defaults; the same file and the same
    ``LLMQ_EXECUTOR_KV_TIERING_*`` variables load to the same values in
    both packages, and the same bad values raise the same errors."""
    assert dataclasses.asdict(TC.KVTieringConfig()) == \
        dataclasses.asdict(JC.KVTieringConfig())
    assert "kv_tiering" not in TC._UNPORTED["executor"]
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text("executor: {kv_tiering: {enabled: true, "
                        "host_capacity_mb: 64, host_max_conversations: 9, "
                        "store_spill: false, promote_timeout_s: 2.5, "
                        "eviction_policy: lru}}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_EXECUTOR_KV_TIERING_ENABLED": "true",
               "LLMQ_EXECUTOR_KV_TIERING_HOST_CAPACITY_MB": "64",
               "LLMQ_EXECUTOR_KV_TIERING_HOST_MAX_CONVERSATIONS": "9",
               "LLMQ_EXECUTOR_KV_TIERING_STORE_SPILL": "false",
               "LLMQ_EXECUTOR_KV_TIERING_PROMOTE_TIMEOUT_S": "2.5",
               "LLMQ_EXECUTOR_KV_TIERING_EVICTION_POLICY": "lru"}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert dataclasses.asdict(t.executor.kv_tiering) == \
        dataclasses.asdict(j.executor.kv_tiering) == {
            "enabled": True, "host_capacity_mb": 64,
            "host_max_conversations": 9, "store_spill": False,
            "promote_timeout_s": 2.5, "eviction_policy": "lru"}
    for bad in ({"host_capacity_mb": -1}, {"host_max_conversations": 0},
                {"promote_timeout_s": 0.0}, {"eviction_policy": "fifo"}):
        with pytest.raises(ValueError) as te:
            TC.KVTieringConfig(**bad)
        with pytest.raises(ValueError) as je:
            JC.KVTieringConfig(**bad)
        assert str(te.value) == str(je.value)


def test_search_order_env_and_missing_path(tmp_path, monkeypatch):
    """``LLMQ_CONFIG`` first, then ./config.yaml, then
    ./configs/config.yaml; a missing explicit path raises in both
    packages; environment overrides win over the file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    assert TC.load_config(environ={}).server.port == 8080  # no file
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "config.yaml").write_text(
        "server: {port: 7001}\n")
    assert TC.load_config(environ={}).server.port == 7001
    (tmp_path / "config.yaml").write_text("server: {port: 7002}\n")
    assert TC.load_config(environ={}).server.port == 7002
    other = tmp_path / "other.yaml"
    other.write_text("server: {port: 7003}\nexecutor: {kv_pages: 64}\n")
    env = {"LLMQ_CONFIG": str(other)}
    assert TC.load_config(environ=env).server.port == 7003
    monkeypatch.setenv("LLMQ_CONFIG", str(other))
    assert JC.load_config().server.port == 7003
    cfg = TC.load_config(environ={**env, "LLMQ_SERVER_PORT": "7004"})
    assert (cfg.server.port, cfg.executor.kv_pages) == (7004, 64)
    missing = str(tmp_path / "missing.yaml")
    for load in (lambda: TC.load_config(missing),
                 lambda: TC.load_config(environ={"LLMQ_CONFIG": missing}),
                 lambda: JC.load_config(missing)):
        with pytest.raises(FileNotFoundError, match="config file not found"):
            load()


def test_env_naming_an_unported_key_raises_unless_default():
    # The disaggregation, control-plane and scenario blocks are ported:
    # their switches now load from the environment as JAX's do, and the
    # case's raise moves to a key still unported.
    with pytest.raises(ValueError, match="server.read_timeout"):
        TC.load_config(path=os.devnull,
                       environ={"LLMQ_SERVER_READ_TIMEOUT": "5.0"})
    env = {"LLMQ_SCENARIOS_ENABLED": "true"}
    j = JC.Config()
    JC._apply_env(j, env)
    assert TC.load_config(path=os.devnull, environ=env).scenarios.enabled \
        == j.scenarios.enabled is True
    env = {"LLMQ_DISAGG_ENABLED": "true", "LLMQ_DISAGG_ROLE": "decode",
           "LLMQ_CONTROLPLANE_ENABLED": "true"}
    j = JC.Config()
    JC._apply_env(j, env)
    t = TC.load_config(path=os.devnull, environ=env)
    assert (t.disagg.enabled, t.disagg.role, t.controlplane.enabled) == \
        (j.disagg.enabled, j.disagg.role, j.controlplane.enabled) == \
        (True, "decode", True)
    env = {"LLMQ_CLUSTER_PEERS": "http://a:8080, http://b:8080/"}
    j = JC.Config()
    JC._apply_env(j, env)
    assert TC.load_config(path=os.devnull, environ=env).cluster.peers == \
        j.cluster.peers == ["http://a:8080", "http://b:8080"]
    cfg = TC.load_config(path=os.devnull,
                         environ={"LLMQ_DISAGG_ENABLED": "false",
                                  "LLMQ_CLUSTER_PEERS": "",
                                  "LLMQ_SCHEDULER_COOLDOWN": "60",
                                  "LLMQ_LOADBALANCER_STRATEGY": "adaptive_load",
                                  "LLMQ_SCHEDULER_MONITOR_INTERVAL": "5"})
    assert cfg.scheduler.monitor_interval == 5.0
    assert (cfg.cluster.peers, cfg.scheduler.cooldown,
            cfg.loadbalancer.strategy) == ([], 60.0, "adaptive_load")
    for var, key in (("LLMQ_LOADBALANCER_STRATEGY", "loadbalancer.strategy"),
                     ("LLMQ_SERVER_READ_TIMEOUT", "server.read_timeout"),
                     ("LLMQ_METRICS_PORT", "metrics.port"),
                     ("LLMQ_LOADBALANCER_MAX_RETRIES",
                      "loadbalancer.max_retries"),
                     ("LLMQ_RESOURCE_SCHEDULER_SCALE_UP_LOAD",
                      "resource_scheduler.scale_up_load")):
        with pytest.raises(ValueError, match=key):
            TC.load_config(path=os.devnull, environ={var: "7"})
    # A malformed numeric list still raises; only the string list
    # (the peers) keeps its raw comma-separated form for its block.
    for var in ("LLMQ_EXECUTOR_PREFILL_BUCKETS",
                "LLMQ_OBSERVABILITY_SLO_WINDOWS_S"):
        with pytest.raises(ValueError):
            TC.load_config(path=os.devnull, environ={var: "128,x"})


def test_levels_merge_and_validation_after_merge(tmp_path):
    """A ``levels`` list replaces the tiers, each merged onto defaults;
    a block is validated after all of its keys are set."""
    path = tmp_path / "c.yaml"
    path.write_text("queue:\n  levels:\n    - {priority: 1, max_wait_time: "
                    "0.5}\n    - {priority: 4}\n"
                    "executor:\n  mixed_batch: {prefill_token_budget: 64, "
                    "max_slices: 4}\n")
    t = TC.load_config(str(path), env=False)
    j = JC.load_config(str(path), env=False)
    assert [vars(x) for x in t.queue.levels] == \
        [{k: getattr(y, k) for k in vars(x)}
         for x, y in zip(t.queue.levels, j.queue.levels)]
    assert len(t.queue.levels) == len(j.queue.levels) == 2
    assert t.executor.mixed_batch.slice_tokens == 16


def test_the_jax_packages_own_file_found_by_the_search_says_what_to_do(
        tmp_path, monkeypatch, capsys):
    """The repository's ``configs/config.yaml`` configures the JAX
    package's echo backend. Found by the search, it raises with the
    remedy; named, it selects the echo backend; the command line turns
    the refusal into exit code 2 and the message, before anything is
    built."""
    from llmq_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "config.yaml").write_text(open(CANONICAL).read())
    with pytest.raises(ValueError, match="found by the config search.*"
                       "pass --config"):
        TC.load_config(environ={})
    # Named, it selects the echo backend (ported since), which only a
    # named file may select.
    assert TC.load_config(os.path.join("configs", "config.yaml")) \
        .executor.backend == "echo"
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "check"])
    assert e.value.code == 2
    assert "pass --config" in capsys.readouterr().err
    port = tmp_path / "port.yaml"
    port.write_text("executor: {backend: torch}\n")
    assert TC.load_config(environ={"LLMQ_CONFIG": str(port)}).executor \
        .backend == "torch"


@pytest.mark.parametrize("snippet", [
    "chaos: {enabled: true, seed: 9, faults: [{point: engine.step, "
    "kind: crash, times: 1, after: 6}, {point: 'store.*', kind: latency, "
    "latency_ms: 300, probability: 0.5, match: {op: kv_get}}]}\n",
    "store: {resilience: {enabled: true, op_timeout_s: 0.5, retries: 0, "
    "timeout_threshold: 2, probe_interval_s: 0.05, replay_buffer: 8, "
    "seed: 4, breaker: {failure_threshold: 5, base_backoff: 0.15, "
    "jitter: 0.0}}}\n",
    "chaos: {enabled: false, faults: [{point: x, kind: bogus}]}\n"
    "store: {resilience: {enabled: false, op_timeout_s: 9.0}}\n",
])
def test_chaos_and_store_blocks_load_like_jaxs(tmp_path, snippet):
    """Tolerance: none. The ported ``chaos`` and ``store.resilience``
    blocks take the same values from the same file as JAX's; a rule's
    kind is checked when the plane is armed, in both."""
    from llmq_tpu import chaos as jchaos

    from llmq_tpu_torch import chaos as tchaos

    path = tmp_path / "c.yaml"
    path.write_text(snippet)
    t = TC.load_config(str(path), env=False)
    j = JC.load_config(str(path), env=False)
    assert dataclasses.asdict(t.chaos) == dataclasses.asdict(j.chaos)
    assert dataclasses.asdict(t.store.resilience) == \
        dataclasses.asdict(j.store.resilience)
    assert t.store.enabled == j.store.enabled
    try:
        for mod, cfg in ((jchaos, j), (tchaos, t)):
            inj = mod.configure(cfg.chaos)
            assert (inj is None) == (not cfg.chaos.enabled)
            if inj is not None:
                assert len(inj.get_stats()["rules"]) == 2
        bad = TC.ChaosConfig(enabled=True, faults=[{"point": "p",
                                                    "kind": "bogus"}])
        for mod in (jchaos, tchaos):
            with pytest.raises(ValueError, match="unknown chaos fault kind"):
                mod.configure(bad)
    finally:
        jchaos.configure(None)
        tchaos.configure(None)


def test_chaos_and_store_env_overrides_like_jaxs(tmp_path, monkeypatch):
    """``LLMQ_*`` variables reach the two blocks, nested breaker included,
    as in JAX's loader; ``LLMQ_EXECUTOR_BACKEND=echo`` names the echo
    backend."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    env = {"LLMQ_CHAOS_ENABLED": "true", "LLMQ_CHAOS_SEED": "17",
           "LLMQ_STORE_RESILIENCE_ENABLED": "true",
           "LLMQ_STORE_RESILIENCE_OP_TIMEOUT_S": "0.4",
           "LLMQ_STORE_RESILIENCE_BREAKER_FAILURE_THRESHOLD": "6",
           "LLMQ_EXECUTOR_BACKEND": "echo"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = TC.load_config()
    j = JC.load_config()
    assert dataclasses.asdict(t.chaos) == dataclasses.asdict(j.chaos)
    assert dataclasses.asdict(t.store.resilience) == \
        dataclasses.asdict(j.store.resilience)
    assert (t.chaos.seed, t.store.resilience.op_timeout_s,
            t.store.resilience.breaker.failure_threshold) == (17, 0.4, 6)
    assert t.executor.backend == j.executor.backend == "echo"


@pytest.mark.parametrize("source", ["file", "env"])
def test_tenancy_block_loads_like_jaxs(tmp_path, source):
    """Tolerance: none. ``tenancy`` is a real block with the JAX package's
    fields and defaults: the same file (or ``LLMQ_TENANCY_*`` variables)
    loads to the same values in both packages; a tenant class is checked
    field by field at load (JAX's checks the weight when the registry is
    configured)."""
    assert dataclasses.asdict(TC.TenancyConfig()) == \
        dataclasses.asdict(JC.TenancyConfig())
    assert "tenancy" not in TC._UNPORTED
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text(
            "tenancy: {enabled: true, share_window_s: 30.0, "
            "default: {weight: 0.5, max_inflight: 3}, tenants: {gold: "
            "{weight: 4.0, token_rate: 200.0, burst-tokens: 400.0}, "
            "bronze: {max_queue_depth: 8}}}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_TENANCY_ENABLED": "true",
               "LLMQ_TENANCY_SHARE_WINDOW_S": "30",
               "LLMQ_TENANCY_DEFAULT_WEIGHT": "0.5"}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert dataclasses.asdict(t.tenancy) == dataclasses.asdict(j.tenancy)
    assert t.tenancy.enabled and t.tenancy.share_window_s == 30.0
    for bad, match in (
            ("tenancy: {default: {weight: 0.0}}\n", "weight must be > 0"),
            ("tenancy: {tenants: {a: {weight: -1}}}\n", "weight must be > 0"),
            ("tenancy: {tenants: {a: 3}}\n", "tenancy.tenants.a must be"),
            ("tenancy: {default: {nope: 1}}\n",
             "unknown config key: tenancy.default.nope")):
        path = tmp_path / "bad.yaml"
        path.write_text(bad)
        with pytest.raises(ValueError, match=match):
            TC.load_config(str(path), env=False)


def test_model_weight_keys_load_like_jaxs(tmp_path):
    """``model.checkpoint_path``, ``tokenizer_path`` and
    ``meta_rope_layout`` are real fields at the JAX package's defaults
    and load to its values. ``dtype`` is read by neither package's
    builder: the port accepts it only at the JAX package's default, and
    another value raises, naming the key."""
    t0, j0 = TC.ModelConfig(), JC.ModelConfig()
    for k in ("checkpoint_path", "tokenizer_path", "meta_rope_layout"):
        assert getattr(t0, k) == getattr(j0, k), k
    assert TC._UNPORTED["model"] == {"dtype": j0.dtype}
    path = tmp_path / "c.yaml"
    path.write_text("model: {name: llama3-1b, checkpoint_path: "
                    "/w/llama3-1b.safetensors.d, tokenizer_path: /w/tok, "
                    "meta_rope_layout: true, dtype: bfloat16}\n")
    t = TC.load_config(str(path), env=False).model
    j = JC.load_config(str(path), env=False).model
    for k in ("name", "checkpoint_path", "tokenizer_path",
              "meta_rope_layout"):
        assert getattr(t, k) == getattr(j, k), k
    path.write_text("model: {name: llama3-1b, dtype: float32}\n")
    with pytest.raises(ValueError, match="model.dtype"):
        TC.load_config(str(path), env=False)
    with pytest.raises(ValueError, match="model.dtype"):
        TC.load_config(path=os.devnull,
                       environ={"LLMQ_MODEL_DTYPE": "float32"})
    env = {"LLMQ_MODEL_CHECKPOINT_PATH": "/x.ckpt",
           "LLMQ_MODEL_META_ROPE_LAYOUT": "true",
           "LLMQ_MODEL_DTYPE": "bfloat16"}
    t = TC.load_config(path=os.devnull, environ=env).model
    assert (t.checkpoint_path, t.meta_rope_layout) == ("/x.ckpt", True)


@pytest.mark.parametrize("source", ["file", "env"])
def test_disagg_and_controlplane_blocks_load_like_jaxs(tmp_path, source):
    """Tolerance: none. ``disagg`` and ``controlplane`` (its ``pool`` and
    ``rungs`` too) are real blocks with the JAX package's fields and
    defaults; the same file and the same ``LLMQ_DISAGG_*`` /
    ``LLMQ_CONTROLPLANE_*`` variables load to the same values in both
    packages, and the same bad values raise the same errors."""
    for block in ("DisaggConfig", "ReplicaPoolConfig", "ControlPlaneConfig"):
        assert dataclasses.asdict(getattr(TC, block)()) == \
            dataclasses.asdict(getattr(JC, block)()), block
    assert "disagg" not in TC._UNPORTED and "controlplane" not in TC._UNPORTED
    rungs = [{"name": "only", "backlog_factor": 0.5,
              "shed_priorities": ["low"]}]
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text(
            "disagg: {enabled: true, role: prefill, long_prompt_tokens: 96,"
            " long_prompt_ms: 40.0, claim_ttl_s: 3.0, miss_ttl_s: 1.0,"
            " publish_on_finish: false, rehydrate_on_start: false}\n"
            "controlplane: {enabled: true, interval: 0.5, min_replicas: 1,"
            " max_replicas: 2, backlog_per_replica: 3, cooldown: 1.0,"
            " rungs: [{name: only, backlog_factor: 0.5,"
            " shed_priorities: [low]}],"
            " pool: {kind: subprocess, base_port: 18300,"
            " args: [--backend, echo], ready_timeout: 90.0}}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_DISAGG_ENABLED": "true", "LLMQ_DISAGG_ROLE": "prefill",
               "LLMQ_DISAGG_LONG_PROMPT_TOKENS": "96",
               "LLMQ_DISAGG_LONG_PROMPT_MS": "40.0",
               "LLMQ_DISAGG_CLAIM_TTL_S": "3.0",
               "LLMQ_DISAGG_MISS_TTL_S": "1.0",
               "LLMQ_DISAGG_PUBLISH_ON_FINISH": "false",
               "LLMQ_DISAGG_REHYDRATE_ON_START": "false",
               "LLMQ_CONTROLPLANE_ENABLED": "true",
               "LLMQ_CONTROLPLANE_INTERVAL": "0.5",
               "LLMQ_CONTROLPLANE_MAX_REPLICAS": "2",
               "LLMQ_CONTROLPLANE_BACKLOG_PER_REPLICA": "3",
               "LLMQ_CONTROLPLANE_COOLDOWN": "1.0",
               "LLMQ_CONTROLPLANE_RUNGS":
                   "[{name: only, backlog_factor: 0.5, "
                   "shed_priorities: [low]}]",
               "LLMQ_CONTROLPLANE_POOL_KIND": "subprocess",
               "LLMQ_CONTROLPLANE_POOL_BASE_PORT": "18300",
               "LLMQ_CONTROLPLANE_POOL_ARGS": "[--backend, echo]",
               "LLMQ_CONTROLPLANE_POOL_READY_TIMEOUT": "90.0"}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert dataclasses.asdict(t.disagg) == dataclasses.asdict(j.disagg) == {
        "enabled": True, "role": "prefill", "long_prompt_tokens": 96,
        "long_prompt_ms": 40.0, "claim_ttl_s": 3.0,
        "publish_on_finish": False, "rehydrate_on_start": False,
        "miss_ttl_s": 1.0}
    tcp, jcp = (dataclasses.asdict(t.controlplane),
                dataclasses.asdict(j.controlplane))
    assert tcp == jcp
    assert (tcp["interval"], tcp["max_replicas"], tcp["rungs"],
            tcp["pool"]["args"], tcp["pool"]["ready_timeout"]) == (
        0.5, 2, rungs, ["--backend", "echo"], 90.0)
    for cls, bad in (("DisaggConfig", {"role": "both"}),
                     ("ReplicaPoolConfig", {"kind": "k8s"}),
                     ("ControlPlaneConfig", {"min_replicas": 0}),
                     ("ControlPlaneConfig", {"min_replicas": 3,
                                             "max_replicas": 2})):
        with pytest.raises(ValueError) as te:
            getattr(TC, cls)(**bad)
        with pytest.raises(ValueError) as je:
            getattr(JC, cls)(**bad)
        assert str(te.value) == str(je.value), cls


@pytest.mark.parametrize("source", ["file", "env"])
def test_scenarios_block_loads_like_jaxs(tmp_path, source):
    """Tolerance: none. ``scenarios`` is a real block with the JAX
    package's fields and defaults, and the same file and the same
    ``LLMQ_SCENARIOS_*`` variables load to the same values in both
    packages; an unknown key in it raises."""
    assert dataclasses.asdict(TC.ScenariosConfig()) == \
        dataclasses.asdict(JC.ScenariosConfig())
    assert "scenarios" not in TC._UNPORTED
    if source == "file":
        path = tmp_path / "c.yaml"
        path.write_text("scenarios: {enabled: true, dir: /specs, run: [a, b],"
                        " scale: 0.05, out_dir: /out, emit_json: false,"
                        " default_seed: 7}\n")
        t = TC.load_config(str(path), env=False)
        j = JC.load_config(str(path), env=False)
        path.write_text("scenarios: {enabled: true, nope: 1}\n")
        with pytest.raises(ValueError, match="scenarios.nope"):
            TC.load_config(str(path), env=False)
    else:
        env = {"LLMQ_SCENARIOS_ENABLED": "true", "LLMQ_SCENARIOS_DIR": "/specs",
               "LLMQ_SCENARIOS_RUN": "[a, b]", "LLMQ_SCENARIOS_SCALE": "0.05",
               "LLMQ_SCENARIOS_OUT_DIR": "/out",
               "LLMQ_SCENARIOS_EMIT_JSON": "false",
               "LLMQ_SCENARIOS_DEFAULT_SEED": "7"}
        t = TC.load_config(path=os.devnull, environ=env)
        j = JC.Config()
        JC._apply_env(j, env)
    assert dataclasses.asdict(t.scenarios) == dataclasses.asdict(j.scenarios)
    assert t.scenarios.run == ["a", "b"] and t.scenarios.scale == 0.05

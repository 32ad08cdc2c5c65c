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
    """configs/config.yaml with only executor.backend changed (the JAX
    package's echo backend is not ported), plus ``extra``."""
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


def test_unported_table_is_jaxs_tree_at_its_defaults():
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
    # A tuple adds the canonical file's value where it differs.
    j = JC.load_config(CANONICAL, env=False)
    assert TC._UNPORTED["loadbalancer"]["strategy"] == (
        JC.Config().loadbalancer.strategy, j.loadbalancer.strategy)


@pytest.mark.parametrize("snippet,match", [
    ("nope: 1\n", "unknown config key: nope"),
    ("server: {nope: 1}\n", "unknown config key: server.nope"),
    ("disagg: {enabled: true}\n", "disagg.enabled"),
    ("executor: {speculation: {enabled: true}}\n",
     "executor.speculation.enabled"),
    ("executor: {kv_tiering: {enabled: true}}\n",
     "executor.kv_tiering.enabled"),
    ("executor: {mesh: {enabled: true, shape: {tp: 2}}}\n",
     "executor.mesh.enabled"),
    ("executor: {backend: echo}\n", "executor.backend"),
    ("executor: {backend: jax}\n", "executor.backend"),
    ("cluster: {peers: [http://a:8080]}\n", "cluster.peers"),
    ("queue: {wal_dir: /var/wal}\n", "queue.wal_dir"),
    ("chaos: {enabled: true, faults: [{point: engine.step, kind: crash}]}\n",
     "chaos.enabled"),
    ("tenancy: {enabled: true}\n", "tenancy.enabled"),
    ("tpu: {mesh_shape: {tp: 8}}\n", "tpu.mesh_shape"),
    ("model: {checkpoint_path: /ckpt}\n", "model.checkpoint_path"),
    ("chaos: {enabled: true, faults: []}\n", "chaos.enabled"),
    ("store: {resilience: {enabled: true}}\n", "store.resilience.enabled"),
    ("controlplane: {enabled: true}\n", "controlplane.enabled"),
    ("disagg: {enabled: false, nope: 1}\n", "unknown config key: disagg.nope"),
    ("loadbalancer: {strategy: fastest}\n", "loadbalancer.strategy"),
    ("loadbalancer: {strategy: least_connections}\n",
     "loadbalancer.strategy"),
    ("loadbalancer: {session_affinity: false}\n",
     "loadbalancer.session_affinity"),
    ("loadbalancer: {max_retries: 5}\n", "loadbalancer.max_retries"),
    ("scheduler: {strategy: priority_weighted}\n", "scheduler.strategy"),
    ("scheduler: {cooldown: 5.0}\n", "scheduler.cooldown"),
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
    with pytest.raises(ValueError, match="disagg.enabled"):
        TC.load_config(path=os.devnull,
                       environ={"LLMQ_DISAGG_ENABLED": "true"})
    with pytest.raises(ValueError, match="cluster.peers"):
        TC.load_config(path=os.devnull,
                       environ={"LLMQ_CLUSTER_PEERS": "http://a:8080"})
    cfg = TC.load_config(path=os.devnull,
                         environ={"LLMQ_DISAGG_ENABLED": "false",
                                  "LLMQ_CLUSTER_PEERS": "",
                                  "LLMQ_SCHEDULER_COOLDOWN": "60",
                                  "LLMQ_LOADBALANCER_STRATEGY": "adaptive_load",
                                  "LLMQ_SCHEDULER_MONITOR_INTERVAL": "5"})
    assert cfg.scheduler.monitor_interval == 5.0
    for var, key in (("LLMQ_LOADBALANCER_STRATEGY", "loadbalancer.strategy"),
                     ("LLMQ_SCHEDULER_COOLDOWN", "scheduler.cooldown"),
                     ("LLMQ_METRICS_PORT", "metrics.port")):
        with pytest.raises(ValueError, match=key):
            TC.load_config(path=os.devnull, environ={var: "7"})


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
    remedy; named, it raises at the key; the command line turns either
    into exit code 2 and the message, before anything is built."""
    from llmq_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "config.yaml").write_text(open(CANONICAL).read())
    with pytest.raises(ValueError, match="found by the config search.*"
                       "pass --config"):
        TC.load_config(environ={})
    with pytest.raises(ValueError, match="executor.backend='echo' is not "
                       "ported"):
        TC.load_config(os.path.join("configs", "config.yaml"))
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "check"])
    assert e.value.code == 2
    assert "pass --config" in capsys.readouterr().err
    port = tmp_path / "port.yaml"
    port.write_text("executor: {backend: torch}\n")
    assert TC.load_config(environ={"LLMQ_CONFIG": str(port)}).executor \
        .backend == "torch"

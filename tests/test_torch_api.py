"""The port's REST contract against the JAX package's ApiServer: one
request sequence, over HTTP, to JAX's ``ApiServer`` (a tiny f32 JAX
engine behind JAX's queue factory, preprocessor and state manager) and
to the port's ``App`` (the same weights through ``params_from_jax``, on
the CPU). Route by route the two must answer with the same status codes
and payload keys and the same greedy responses; priorities are the
preprocessor's; the SSE framing matches; the shedder answers 429 and 503
with ``Retry-After``; dead letters are requeued; the resources and
endpoints routes, ``/metrics`` and the admin drain answer as JAX's (its
process here wired with a load balancer and a resource scheduler as its
``App`` wires them)."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.api import ApiServer as JApiServer  # noqa: E402
from llmq_tpu.api import MessageStore as JMessageStore  # noqa: E402
from llmq_tpu.core.config import Config as JConfig  # noqa: E402
from llmq_tpu.conversation.state_manager import StateManager as JSM  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.loadbalancer.load_balancer import LoadBalancer as JLB  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.preprocessor.preprocessor import Preprocessor as JPre  # noqa: E402
from llmq_tpu.queueing.factory import QueueFactory as JFactory  # noqa: E402
from llmq_tpu.queueing.factory import QueueType as JQueueType  # noqa: E402
from llmq_tpu.scheduling import resource_scheduler as jrs  # noqa: E402
from llmq_tpu.scheduling.topology import TpuTopology  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from llmq_tpu_torch.__main__ import App  # noqa: E402
from llmq_tpu_torch.core.config import Config  # noqa: E402
from llmq_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=16, num_pages=128, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8)


def _tune(cfg):
    """The same serving settings in both packages' configs. No deadline
    shedding: with a learned prefill rate both shedders refuse every
    LOW message with the default 30 s timeout before a LOW wait is
    measured (30 s table estimate + the prefill ETA), and the script
    needs its LOW messages (``test_torch_scheduling.py`` holds that
    check against JAX's)."""
    cfg.queue.retry.initial_backoff = 0.05
    cfg.queue.worker.process_interval = 0.01
    cfg.queue.worker.count = 2
    cfg.overload.deadline_headroom = 0.0
    return cfg


class _JaxProcess:
    """JAX's serving process around its ApiServer, wired as its App
    wires these parts: the load balancer, the resource scheduler with
    cache-aware admission and the engine's chip allocation (CPU
    devices, one resource each; no heartbeat thread)."""

    def __init__(self, engine) -> None:
        cfg = _tune(JConfig())
        self.factory = JFactory(cfg)
        for name, qt in (("standard", "standard"), ("delayed", "delayed"),
                         ("priority", "priority")):
            self.factory.create_queue_manager(name, JQueueType(qt))
        self.state_manager = JSM(cfg.conversation)
        self.engine = engine
        engine.attach_conversation_manager(self.state_manager)
        self.load_balancer = JLB(cfg.loadbalancer)
        rs = self.resource_scheduler = jrs.ResourceScheduler(
            cfg.resource_scheduler)
        rs.set_prefill_estimator(lambda md: engine.prefill_estimate(
            str(md.get("conversation_id", "")),
            int(md.get("prompt_tokens", 0) or 0)))
        engine.on_prefill_observed = rs.observe_prefill
        rs.register_topology_resources(TpuTopology.discover(),
                                       chips_per_resource=1)
        rs.request_resource_now(jrs.ResourceRequest(
            capabilities={"tpu"}, amounts={jrs.ResourceType.CHIP: 1.0},
            metadata={"engine": engine.name, "pinned": True}))
        self.workers = self.factory.create_workers(
            "standard", cfg.queue.worker.count, engine.process_fn,
            start=False)
        self.api = JApiServer(cfg, queue_factory=self.factory,
                              preprocessor=JPre(),
                              state_manager=self.state_manager,
                              load_balancer=self.load_balancer,
                              resource_scheduler=rs,
                              engine=engine, message_store=JMessageStore())

    def start(self) -> int:
        self.engine.start()
        for w in self.workers:
            w.start()
        return self.api.start(host="127.0.0.1", port=0)

    def stop(self) -> None:
        self.api.stop()
        self.factory.stop_all()
        self.engine.stop()


def _http(base, method, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _scrape(base):
    """(status, content type, text) of ``GET /metrics``."""
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], \
            resp.read().decode()


def _sse(base, body):
    """(status, content type, body, traceparent header) of an SSE
    request."""
    req = urllib.request.Request(base + "/api/v1/messages",
                                 data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers["Content-Type"], \
            resp.read().decode(), resp.headers.get("traceparent")


def _poll(base, mid, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, m, _ = _http(base, "GET", f"/api/v1/messages/{mid}")
        if m.get("status") in ("completed", "failed", "timeout"):
            return _core(m)
        time.sleep(0.02)
    raise AssertionError(f"{mid} did not finish")


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


#: The usage plane's measured fields in every ``usage`` block: seconds
#: of two different engines' device time and page residency, compared
#: by type; every other usage field (the token counts, the finish and
#: waste reasons, the tenant) is compared by value.
USAGE_MEASURED = {"device_seconds", "waste_seconds", "kv_page_seconds",
                  "saved_prefill_device_seconds"}


def _core(x):
    """``x`` with the usage plane's measured seconds replaced by their
    type name (so a ``usage`` block compares whole: every key, every
    other value)."""
    if isinstance(x, dict):
        return {k: ({u: (type(w).__name__ if u in USAGE_MEASURED
                         else _core(w)) for u, w in v.items()}
                    if k == "usage" and isinstance(v, dict) else _core(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_core(v) for v in x]
    return x


def _keys(x):
    """The shape of a payload: dict keys, recursively (list → its first
    element's shape)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return type(x).__name__ if x is not None else None


def _paths(x, pre=""):
    """Flattened key paths of a payload (for readable failures)."""
    if isinstance(x, dict):
        return set().union(*([{pre + k} | _paths(v, pre + k + ".")
                              for k, v in x.items()] or [set()]))
    if isinstance(x, list) and x:
        return _paths(x[0], pre + "[]")
    return set()


def _script(base, proc, dlq, stop_workers):
    """The request sequence; returns {step: (status, payload)} plus the
    SSE transcript. ``proc`` is the process object (engine access)."""
    out = {}

    def rec(step, method, path, body=None, raw=None):
        status, payload, headers = _http(base, method, path, body, raw)
        out[step] = (status, _core(payload), headers.get("Retry-After"))
        return status, payload

    rec("health", "GET", "/health")
    _, r = rec("submit_urgent", "POST", "/api/v1/messages", {
        "content": "urgent: fix the queue", "user_id": "u1",
        "metadata": {"max_new_tokens": 6}})
    out["urgent_done"] = (200, _poll(base, r["message_id"]), None)
    _, r = rec("submit_explicit", "POST", "/api/v1/messages", {
        "content": "an emergency, but filed low", "priority": "low",
        "user_id": "u1", "metadata": {"max_new_tokens": 4}})
    out["explicit_done"] = (200, _poll(base, r["message_id"]), None)
    _, r = rec("submit_user_priority", "POST", "/api/v1/messages", {
        "content": "plain words", "user_id": "u2",
        "metadata": {"user_priority": "realtime", "max_new_tokens": 4}})
    _poll(base, r["message_id"])
    rec("user_prio_set", "POST", "/api/v1/admin/preprocessor/user-priorities",
        {"user_id": "vip", "priority": "high"})
    rec("user_prio_bad", "POST",
        "/api/v1/admin/preprocessor/user-priorities",
        {"user_id": "vip", "priority": "gold"})
    rec("user_prio_missing", "POST",
        "/api/v1/admin/preprocessor/user-priorities", {"user_id": "vip"})
    rec("submit_vip", "POST", "/api/v1/messages", {
        "content": "plain words again", "user_id": "vip",
        "metadata": {"max_new_tokens": 4}})
    rec("rule_add", "POST", "/api/v1/admin/preprocessor/rules",
        {"pattern": "^deploy", "priority": "realtime", "name": "deploys"})
    rec("rule_bad", "POST", "/api/v1/admin/preprocessor/rules",
        {"pattern": "(", "priority": "high"})
    rec("rule_missing", "POST", "/api/v1/admin/preprocessor/rules",
        {"priority": "high"})
    rec("rule_list", "GET", "/api/v1/admin/preprocessor/rules")
    _, r = rec("submit_rule", "POST", "/api/v1/messages", {
        "content": "deploy the fix", "user_id": "u3",
        "metadata": {"max_new_tokens": 4}})
    rule_id = r["message_id"]
    out["rule_done"] = (200, _poll(base, rule_id), None)
    rec("list_u1", "GET", "/api/v1/messages?user_id=u1&limit=5")
    rec("list_bad", "GET", "/api/v1/messages?limit=x")
    rec("get_missing", "GET", "/api/v1/messages/nope")
    # Conversations: three turns, each after the previous one finished.
    _, c = rec("conv_create", "POST", "/api/v1/conversations",
               {"user_id": "alice", "metadata": {"topic": "kv"}})
    rec("conv_create_bad", "POST", "/api/v1/conversations", {})
    cid = c["conversation_id"]
    turns = []
    for i, text in enumerate(["Tell me about paged attention.",
                              " Shorter, please.", " Once more."]):
        _, r = rec(f"conv_turn{i}", "POST",
                   f"/api/v1/conversations/{cid}/messages",
                   {"content": text, "metadata": {"max_new_tokens": 6}})
        turns.append(_poll(base, r["message_id"]))
    out["conv_turns"] = (200, turns, None)
    rec("conv_get", "GET", f"/api/v1/conversations/{cid}")
    rec("conv_state", "PUT", f"/api/v1/conversations/{cid}/state",
        {"state": "completed"})
    rec("conv_get_after", "GET", f"/api/v1/conversations/{cid}")
    rec("conv_state_bad", "PUT", f"/api/v1/conversations/{cid}/state",
        {"state": "sleeping"})
    rec("conv_state_missing", "PUT", f"/api/v1/conversations/{cid}/state",
        {})
    rec("conv_unknown", "GET", "/api/v1/conversations/nope")
    rec("conv_state_unknown", "PUT", "/api/v1/conversations/nope/state",
        {"state": "paused"})
    rec("user_convs", "GET", "/api/v1/users/alice/conversations")
    out["pinned_after_turns"] = (200, cid in proc.engine.cached_conversations(),
                                 None)
    # Synchronous generation, and the SSE stream of a queued prompt.
    rec("generate", "POST", "/api/v1/generate",
        {"content": "generate this", "metadata": {"max_new_tokens": 5}})
    _, r = rec("queued_twin", "POST", "/api/v1/messages", {
        "content": "stream this prompt", "priority": "high",
        "metadata": {"max_new_tokens": 8}})
    out["queued_twin_done"] = (200, _poll(base, r["message_id"]), None)
    out["sse"] = (200, _sse(base, {"content": "stream this prompt",
                                   "priority": "high", "stream": True,
                                   "metadata": {"max_new_tokens": 8}}),
                  None)
    rec("stream_bad", "POST", "/api/v1/messages",
        {"content": "x", "stream": "maybe"})
    # A message that fails on every attempt: retried, then dead-lettered.
    _, r = rec("submit_doomed", "POST", "/api/v1/messages", {
        "content": "never works", "priority": "low",
        "metadata": {"max_new_tokens": "lots"}})
    doomed = r["message_id"]
    out["doomed_done"] = (200, _poll(base, doomed), None)
    assert _wait(lambda: dlq().size() == 1)
    rec("dlq_requeue", "POST", f"/api/v1/admin/dead-letter/requeue/{doomed}")
    rec("dlq_requeue_missing", "POST",
        "/api/v1/admin/dead-letter/requeue/nope")
    assert _wait(lambda: dlq().size() == 1)
    rec("dlq_requeue_all", "POST", "/api/v1/admin/dead-letter/requeue-all")
    assert _wait(lambda: dlq().size() == 1)
    rec("queue_stats", "GET", "/api/v1/queues/stats")
    rec("engine_stats", "GET", "/api/v1/engine/stats")
    # The resource scheduler and the load balancer. The endpoints are
    # local:// ones: the health probe contacts nothing.
    rec("res_register", "POST", "/api/v1/resources", {
        "id": "ext-1", "capacity": {"chip": 2, "hbm_gb": 160.0},
        "capabilities": ["cuda"], "endpoint": "local://ext-1"})
    rec("res_register_bad", "POST", "/api/v1/resources",
        {"capacity": {"warp": 1}})
    rec("res_register_no_body", "POST", "/api/v1/resources", raw=b"")
    rec("res_list", "GET", "/api/v1/resources")
    rec("res_stats", "GET", "/api/v1/resources/stats")
    rec("ep_register", "POST", "/api/v1/endpoints",
        {"id": "ep-1", "url": "local://replica-1", "weight": 2})
    rec("ep_register_bad", "POST", "/api/v1/endpoints", {"status": "sleepy"})
    rec("ep_list", "GET", "/api/v1/endpoints")
    rec("ep_stats", "GET", "/api/v1/endpoints/stats")
    rec("ep_drain", "POST", "/api/v1/endpoints/ep-1/drain")
    rec("ep_stats_draining", "GET", "/api/v1/endpoints/stats")
    rec("ep_undrain", "POST", "/api/v1/endpoints/ep-1/drain",
        {"drain": False})
    rec("ep_drain_missing", "POST", "/api/v1/endpoints/nope/drain")
    rec("ep_delete", "DELETE", "/api/v1/endpoints/ep-1")
    rec("ep_delete_missing", "DELETE", "/api/v1/endpoints/ep-1")
    rec("ep_method", "PUT", "/api/v1/endpoints/ep-1")
    out["metrics"] = (200, _scrape(base), None)
    # The observability routes: traces of a queued and a streamed
    # request, the flight recorder, the usage ledger, the critical path
    # and an on-demand profile (202, 409 while it runs, then done).
    sse_id = json.loads(out["sse"][1][2].split("\n\n")[0]
                        .split("data: ", 1)[1])["message_id"]
    out["sse_id"] = (200, sse_id, None)
    rec("trace_queued", "GET", f"/api/v1/requests/{rule_id}/trace")
    rec("trace_sse", "GET", f"/api/v1/requests/{sse_id}/trace")
    rec("trace_chrome", "GET",
        f"/api/v1/requests/{rule_id}/trace?format=chrome")
    rec("trace_missing", "GET", "/api/v1/requests/nope/trace")
    rec("flightrecorder", "GET", "/api/v1/admin/flightrecorder?limit=5")
    rec("flightrecorder_bad", "GET", "/api/v1/admin/flightrecorder?limit=x")
    rec("usage", "GET", "/api/v1/usage")
    rec("usage_tenant", "GET", "/api/v1/usage?tenant=default")
    rec("critical_path", "GET", "/api/v1/analysis/critical-path")
    rec("critical_path_bad", "GET",
        "/api/v1/analysis/critical-path?recent=x")
    rec("profile_start", "POST", "/api/v1/admin/profile",
        {"duration_ms": 300, "label": "api test"})
    rec("profile_again", "POST", "/api/v1/admin/profile",
        {"duration_ms": 300})
    assert _wait(lambda: not _http(base, "GET",
                                   "/api/v1/admin/profile")[1]["active"])
    rec("profile_done", "GET", "/api/v1/admin/profile")
    rec("bad_json", "POST", "/api/v1/messages", raw=b"{nope")
    rec("no_body", "POST", "/api/v1/messages", raw=b"")
    rec("bad_priority", "POST", "/api/v1/messages",
        {"content": "x", "priority": "urgent-ish"})
    rec("not_found", "GET", "/api/v1/nothing")
    rec("method", "POST", "/health")
    # With the workers stopped, messages stay pending: admin removal,
    # then the backlog shed.
    stop_workers()
    _, r = rec("pending_submit", "POST", "/api/v1/messages",
               {"content": "waits", "priority": "low"})
    rec("remove", "DELETE", f"/api/v1/admin/queues/standard/{r['message_id']}")
    rec("remove_again", "DELETE",
        f"/api/v1/admin/queues/standard/{r['message_id']}")
    rec("remove_bad_manager", "DELETE", "/api/v1/admin/queues/nomgr/x")
    proc.api.shedder.queue_depth_limit = 1
    rec("fill", "POST", "/api/v1/messages", {"content": "fills the queue"})
    rec("shed_backlog", "POST", "/api/v1/messages", {"content": "one more"})
    proc.engine.stop()
    rec("health_stopped", "GET", "/health")
    rec("shed_engine_down", "POST", "/api/v1/messages", {"content": "x"})
    rec("generate_down", "POST", "/api/v1/generate", {"content": "x"})
    rec("drain", "POST", "/api/v1/admin/drain")
    rec("health_draining", "GET", "/health")
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    results = {}
    # A boot record an earlier test file opened in this worker process
    # would show on /health in one package only.
    from llmq_tpu.observability import critical_path as jcp

    from llmq_tpu_torch.observability import critical_path as tcp
    jcp._PROCESS_BOOT_ID = tcp._PROCESS_BOOT_ID = None
    # Nor may the requests an earlier test file served count in one
    # package's usage ledger or flight recorder only.
    from llmq_tpu.observability import recorder as jrec
    from llmq_tpu.observability import usage as jusage

    from llmq_tpu_torch.observability import recorder as trec
    from llmq_tpu_torch.observability import usage as tusage
    for mod in (jusage, tusage):
        mod.reset_usage()
    for mod in (jrec, trec):
        mod.get_recorder().clear()
    jproc = _JaxProcess(JEngine(JaxExecutor(jcfg, jparams, **GEOM), JTok(),
                                enable_metrics=False, max_decode_steps=16))
    base = f"http://127.0.0.1:{jproc.start()}"
    try:
        results["jax"] = _script(
            base, jproc,
            lambda: jproc.factory.get_dead_letter_queue("standard"),
            lambda: [w.stop() for w in jproc.workers])
    finally:
        jproc.stop()
    cfg = _tune(Config())
    cfg.device = "cpu"
    cfg.executor.supervisor.enabled = False   # the JAX side runs none
    teng = InferenceEngine(TorchExecutor(tcfg, tparams, device="cpu", **GEOM),
                           ByteTokenizer(), max_decode_steps=16)
    app = App(cfg, engine=teng)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    try:
        results["port"] = _script(
            base, app,
            lambda: app.factory.get_dead_letter_queue("standard"),
            lambda: [w.stop() for w in app.workers])
    finally:
        app.stop()
    return results


STEPS_SAME_PAYLOAD_KEYS = [
    "health", "submit_urgent", "submit_explicit", "submit_user_priority",
    "user_prio_set", "user_prio_bad", "user_prio_missing", "submit_vip",
    "rule_add", "rule_bad", "rule_missing", "rule_list", "submit_rule",
    "list_u1", "list_bad", "get_missing", "conv_create", "conv_create_bad",
    "conv_turn0", "conv_turn1", "conv_turn2", "conv_get", "conv_state",
    "conv_get_after", "conv_state_bad", "conv_state_missing", "conv_unknown",
    "conv_state_unknown", "user_convs", "queued_twin", "stream_bad",
    "submit_doomed", "dlq_requeue", "dlq_requeue_missing", "dlq_requeue_all",
    "queue_stats", "bad_json", "no_body", "bad_priority", "not_found",
    "method", "pending_submit", "remove", "remove_again",
    "remove_bad_manager", "fill", "shed_backlog", "health_stopped",
    "shed_engine_down", "generate_down", "res_register", "res_register_bad",
    "res_register_no_body", "res_list", "res_stats", "ep_register",
    "ep_register_bad", "ep_list", "ep_stats", "ep_drain",
    "ep_stats_draining", "ep_undrain", "ep_drain_missing", "ep_delete",
    "ep_delete_missing", "ep_method", "drain", "health_draining"]


@pytest.mark.parametrize("step", STEPS_SAME_PAYLOAD_KEYS)
def test_route_answers_like_jax(runs, step):
    """Tolerance: none. The same status code and payload keys (and the
    same ``Retry-After`` presence) as JAX's ApiServer."""
    j, t = runs["jax"][step], runs["port"][step]
    assert t[0] == j[0], (step, t, j)
    assert _keys(t[1]) == _keys(j[1]), (
        step, sorted(_paths(t[1]) ^ _paths(j[1])), t[1], j[1])
    assert (t[2] is None) == (j[2] is None), step


def test_greedy_responses_and_usage_match_jax(runs):
    """Tolerance: none. The queued messages' responses, usage and
    message payload keys are JAX's (f32 weights, greedy)."""
    for step in ("urgent_done", "explicit_done", "rule_done",
                 "queued_twin_done"):
        j, t = runs["jax"][step][1], runs["port"][step][1]
        assert t["status"] == j["status"] == "completed", step
        assert t["response"] == j["response"], step
        assert t["metadata"]["usage"] == j["metadata"]["usage"], step
        assert set(t) == set(j) and set(t["metadata"]) == set(j["metadata"])
    jt, tt = runs["jax"]["conv_turns"][1], runs["port"]["conv_turns"][1]
    assert [m["response"] for m in tt] == [m["response"] for m in jt]
    assert [m["metadata"]["usage"] for m in tt] == \
        [m["metadata"]["usage"] for m in jt]
    assert all(m["metadata"]["usage"]["cached_tokens"] > 0 for m in tt[1:])
    j, t = runs["jax"]["generate"], runs["port"]["generate"]
    assert t[0] == j[0] == 200
    assert t[1]["response"] == j[1]["response"]
    assert t[1]["usage"] == j[1]["usage"]


def test_priorities_are_the_preprocessors(runs):
    """A keyword with no explicit priority is served HIGH; an explicit
    priority wins over keywords; metadata.user_priority, a user default
    and an admin rule each set the tier, as in JAX."""
    for side in ("jax", "port"):
        r = runs[side]
        got = [r[s][1]["priority"] for s in (
            "submit_urgent", "submit_explicit", "submit_user_priority",
            "submit_vip", "submit_rule")]
        assert got == [2, 4, 1, 2, 1], side
        assert r["urgent_done"][1]["priority"] == 2
        md = r["urgent_done"][1]["metadata"]
        assert md["analyzed"] is True and json.loads(md["analysis"])


def test_conversation_holds_turns_and_state(runs):
    for side in ("jax", "port"):
        r = runs[side]
        conv = r["conv_get"][1]
        assert conv["message_count"] == 3
        assert all(m["response"] for m in conv["messages"])
        assert r["conv_get_after"][1]["state"] == "completed"
        assert r["pinned_after_turns"][1], side   # update_state keeps KV


def test_sse_framing_and_text_match_the_queued_response(runs):
    """Tolerance: none. ``data:`` events, then one ``event: done`` with
    ``first_token_ms``; the joined text is the same prompt's queued
    greedy response; the framing matches JAX's."""
    shapes = {}
    for side in ("jax", "port"):
        status, ctype, body, _tp = runs[side]["sse"][1]
        assert status == 200 and ctype.startswith("text/event-stream")
        events = [e for e in body.split("\n\n") if e]
        assert events[0].startswith("event: start\ndata: ")
        assert events[-1].startswith("event: done\ndata: ")
        done = _core(json.loads(events[-1].split("data: ", 1)[1]))
        assert done["first_token_ms"] is not None
        assert done["finish_reason"] == "length"
        datas = [json.loads(e[len("data: "):])["token"] for e in events[1:-1]]
        assert all(e.startswith("data: ") for e in events[1:-1])
        assert "".join(datas) == \
            runs[side]["queued_twin_done"][1]["response"]
        shapes[side] = (_keys(json.loads(events[0].split("data: ", 1)[1])),
                        _keys(done))
    assert shapes["port"] == shapes["jax"]


def test_dead_letter_after_retries_then_requeue(runs):
    for side in ("jax", "port"):
        r = runs[side]
        m = r["doomed_done"][1]
        assert m["status"] == "failed" and m["retry_count"] == 3, side
        assert r["dlq_requeue"][0] == 200
        assert r["dlq_requeue_all"][1]["count"] == 1


def test_shedder_429_and_503_carry_retry_after(runs):
    for side in ("jax", "port"):
        r = runs[side]
        assert r["shed_backlog"][0] == 429 and r["shed_backlog"][2]
        assert r["shed_engine_down"][0] == 503 and r["shed_engine_down"][2]
        assert "retry_after" in r["shed_backlog"][1]
        assert r["health_stopped"][1]["engine"] == "stopped"
        assert r["generate_down"][0] == 503


def test_engine_stats_keys_are_jaxs(runs):
    """The port's engine stats are a subset of JAX's (JAX adds planes
    the port does not have yet)."""
    j, t = runs["jax"]["engine_stats"], runs["port"]["engine_stats"]
    assert t[0] == j[0] == 200
    assert set(t[1]) <= set(j[1]), set(t[1]) - set(j[1])


def _stages(trace):
    return [e["stage"] for e in trace["events"]]


def test_observability_routes_answer_like_jax(runs):
    """Tolerance: none. The trace, flight-recorder, usage, critical-path
    and profile routes answer with JAX's status codes and payload keys;
    a queued and a streamed request carry JAX's stage names in the same
    order; the streamed response's ``traceparent`` carries the request's
    derived trace id."""
    from llmq_tpu_torch.observability import trace_id_for

    for step in ("trace_queued", "trace_sse", "trace_chrome",
                 "trace_missing", "flightrecorder", "flightrecorder_bad",
                 "usage", "usage_tenant", "critical_path",
                 "critical_path_bad", "profile_start", "profile_again",
                 "profile_done"):
        j, t = runs["jax"][step], runs["port"][step]
        assert t[0] == j[0], (step, t, j)
        assert set(t[1]) == set(j[1]), (step, t[1], j[1])
    for side in ("jax", "port"):
        r = runs[side]
        assert [r[s][0] for s in ("trace_queued", "trace_missing",
                                  "profile_start", "profile_again",
                                  "profile_done", "flightrecorder_bad",
                                  "critical_path_bad")] == \
            [200, 404, 202, 409, 200, 400, 400], side
        assert r["profile_done"][1]["last"]["label"] == "api_test"
        assert r["critical_path"][1]["conservation_failures"] == 0
        assert r["critical_path"][1]["requests"] > 0
        sse_id = r["sse_id"][1]
        tp = r["sse"][1][3]
        assert tp.split("-")[1] == trace_id_for(sse_id), side
    for step in ("trace_queued", "trace_sse"):
        j, t = runs["jax"][step][1], runs["port"][step][1]
        assert _stages(t) == _stages(j), step
        assert _keys(t["tokens"]) == _keys(j["tokens"])
        assert t["tokens"] == j["tokens"] and t["usage"] == j["usage"]
        assert set(t["critical_path"]) == set(j["critical_path"])
    assert "dispatched" in _stages(runs["port"]["trace_sse"][1])
    j, t = runs["jax"]["usage"][1], runs["port"]["usage"][1]
    for block in ("totals", "goodput"):
        assert set(t[block]) == set(j[block]), block
    for block in ("tenants", "priorities"):
        assert _keys(t[block]) == _keys(j[block]), block
        assert {k: v["requests"] for k, v in t[block].items()} == \
            {k: v["requests"] for k, v in j[block].items()}, block
    assert t["totals"]["requests"] == j["totals"]["requests"]
    j, t = runs["jax"]["flightrecorder"][1], runs["port"]["flightrecorder"][1]
    assert t["timelines"] == j["timelines"] and len(t["recent"]) == 5


def test_metrics_route_serves_jaxs_families(runs):
    """``GET /metrics`` answers 200 in the text format; every family the
    port serves is one of JAX's, of the same type; the queue plane's
    counters moved in both."""
    fams = {}
    for side in ("jax", "port"):
        status, ctype, text = runs[side]["metrics"][1]
        assert status == 200 and ctype.startswith("text/plain"), side
        fams[side] = {f.name: f for f in
                      text_string_to_metric_families(text)}
    assert set(fams["port"]) <= set(fams["jax"])
    for name, fam in fams["port"].items():
        assert fam.type == fams["jax"][name].type, name
    done = fams["port"]["llm_queue_messages_completed"].samples
    assert sum(s.value for s in done) > 0


def test_resources_list_the_engines_allocated_chip(runs):
    """The port's process registered its device (the CPU here) as a
    chip resource and holds it for the engine; a posted resource joins
    it, as in JAX's process."""
    res = runs["port"]["res_list"][1]["resources"]
    own = [r for r in res if r["id"] != "ext-1"]
    assert len(own) == 1 and own[0]["capabilities"] == ["cpu"]
    assert own[0]["capacity"] == {"chip": 1.0, "hbm_gb": 16.0}
    assert own[0]["used"] == {"chip": 1.0}
    assert any(r["id"] == "ext-1" for r in res)
    for side in ("jax", "port"):
        stats = runs[side]["res_stats"][1]
        assert stats["allocations"] == 1, side
        assert stats["prefill_observations"] > 0, side


def test_endpoint_drain_and_admin_drain_like_jax(runs):
    for side in ("jax", "port"):
        r = runs[side]
        assert r["ep_drain"][1] == {"endpoint_id": "ep-1",
                                    "status": "draining"}
        assert r["ep_stats_draining"][1]["draining"] == 1
        assert r["ep_undrain"][1]["status"] == "degraded"
        assert r["ep_delete_missing"][0] == 404
        assert r["drain"][:2] == (202, {"status": "draining"})
        assert r["health_draining"][1]["status"] == "draining", side

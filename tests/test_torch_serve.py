"""The port's servers on the CPU (after ``tests/test_serve.py`` and
``tests/test_qos.py``, with ``scheduler="wave"``): every request finishes
with its tokens, the live ``SessionServer`` and the batch-drain
``ContinuousBatchingServer`` give identical tokens, and both equal a plain
greedy loop over the port's own ``prefill``/``decode_step``. The window
co-schedules one slot's prefill with another's decode; prompt buffers are
freed; the admission FIFO pushes back; QoS orders admission; preempted
token streams are bit-identical to unpreempted ones; the device server
(``scheduler="device"``) gives the same tokens and releases prompt rows
through the pool's free hook; and every scheduler of the reference
builds (the mesh server's own tests are in ``test_torch_mesh.py``). The
server-against-greedy tests run reduced danube,
recurrentgemma, granite-moe (MoE FFNs), deepseek-v2 (MLA caches, MoE with
a shared expert) and falcon-mamba (Mamba states). A fresh admission on a
reused slot starts from a zero recurrent state and conv tail (RG-LRU and
Mamba), and the servers refuse a frontend arch, as the reference's do.

Token streams are compared only inside the port: against the reference,
the models are held by their logits (``tests/test_torch_models.py``).
"""

import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.runtime import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    AdmissionQueueFull,
    ContinuousBatchingServer,
    DrainTimeout,
    SessionServer,
)

CPU = dict(device="cpu")
WAVE = dict(CPU, scheduler="wave")


@functools.lru_cache(maxsize=None)
def _model(key):
    if key == "danube":  # tests/test_serve.py's tiny config
        cfg = dataclasses.replace(ARCHS["h2o-danube-3-4b"].reduced(), n_layers=1, d_model=32,
                                  d_ff=64, vocab=64, n_heads=2, n_kv_heads=1, head_dim=16)
    elif key == "granite":  # MoE FFNs: 4 experts padded to 16, top-2
        cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    elif key == "deepseek":  # MLA, a dense first layer, MoE with a shared expert
        cfg = ARCHS["deepseek-v2-236b"].reduced()
    elif key == "falcon_mamba":  # Mamba layers, no FFN
        cfg = ARCHS["falcon-mamba-7b"].reduced()
    else:
        cfg = dataclasses.replace(ARCHS["recurrentgemma-2b"].reduced(), n_layers=5)
    return cfg, init_params(cfg, 0, **CPU)


@pytest.fixture(scope="module")
def tiny():
    return _model("danube")


def _prompts(cfg, n, seed=0, length=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, length) for _ in range(n)]


def _no_prompt_buffers(pool):
    return [b.name for b in pool.buffers() if b.name.endswith("_prompt")] == []


def _greedy(cfg, params, prompt, max_new, max_len):
    cache = init_cache(cfg, 1, max_len, **CPU)
    logits, cache = prefill(params, cfg, torch.tensor(prompt[None], dtype=torch.int32), cache)
    out = []
    pos = len(prompt)
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
    for _ in range(max_new):
        logits, cache = decode_step(params, cfg, tok[:, None], cache, pos)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        out.append(int(tok[0]))
        pos += 1
    return out


def _serve(server, prompts, max_new):
    for p in prompts:
        server.submit(p, max_new=max_new)
    done = server.run_until_drained()
    if isinstance(server, SessionServer):
        server.close()
    return {tuple(r.prompt): r.generated for r in done}


SERVED = ["danube", "recurrentgemma", "granite", "deepseek", "falcon_mamba"]


@pytest.mark.parametrize("key", SERVED)
def test_servers_match_each_other_and_a_greedy_loop(key):
    cfg, params = _model(key)
    prompts = _prompts(cfg, 5, seed=1, length=7)
    live = SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE)
    got = _serve(live, prompts, 3)
    batch = _serve(ContinuousBatchingServer(cfg, params, max_slots=2, max_len=32, **CPU),
                   prompts, 3)
    assert got == batch
    assert len(got) == len(prompts) and all(len(t) == 3 for t in got.values())
    for p in prompts:
        assert got[tuple(p)] == _greedy(cfg, params, p, 3, 32)
    # one host read per harvested token, and no other
    assert live.host_reads == 3 * len(prompts)


def test_requests_finish_with_their_token_counts(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE)
    reqs = [server.submit(p, max_new=3) for p in _prompts(cfg, 4)]
    done = server.run_until_drained()
    server.close()
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    for r in done:
        assert len(r.generated) == 3
        assert r.t_finish >= r.t_admit >= r.t_arrival > 0
        assert r.latency is not None and r.latency > 0


def test_window_coschedules_prefill_with_inflight_decode(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE)
    kinds = {}
    server.session.add_retire_listener(lambda t: kinds.__setitem__(t.tid, t.opcode))
    prompts = _prompts(cfg, 2, seed=2)
    server.submit(prompts[0], max_new=4)
    for _ in range(3):
        server.pump()  # request 0 prefilled and decoding
    server.submit(prompts[1], max_new=4)  # arrives mid-decode
    server.run_until_drained()
    report = server.close()
    mixed = [w for w in report.waves if len({kinds[t] for t in w}) > 1]
    assert mixed, "no wave co-scheduled a prefill with the in-flight decode"
    assert not server.task_kinds, "task_kinds must drain with retirements"


@pytest.mark.parametrize("server_cls", [SessionServer, ContinuousBatchingServer])
def test_no_prompt_buffer_leak(tiny, server_cls):
    cfg, params = tiny
    server = server_cls(cfg, params, max_slots=2, max_len=32, **CPU)
    _serve(server, _prompts(cfg, 4, seed=7), 2)
    assert _no_prompt_buffers(server.pool)


@pytest.mark.parametrize("server_cls", [SessionServer, ContinuousBatchingServer])
def test_admission_queue_full_at_capacity(tiny, server_cls):
    cfg, params = tiny
    server = server_cls(cfg, params, max_slots=1, max_len=32, max_queue=2, **CPU)
    prompts = _prompts(cfg, 3, seed=6)
    r0, r1 = server.submit(prompts[0]), server.submit(prompts[1])
    assert (r0.queue_depth, r1.queue_depth) == (1, 2)
    with pytest.raises(AdmissionQueueFull):
        server.submit(prompts[2])
    assert server.queue_depth() == 2


@pytest.mark.parametrize("server_cls", [SessionServer, ContinuousBatchingServer])
def test_submit_validates_requests(tiny, server_cls):
    cfg, params = tiny
    server = server_cls(cfg, params, max_slots=1, max_len=8, **CPU)
    with pytest.raises(ValueError, match="prompt length"):
        server.submit(np.zeros(8, np.int32))  # max_len - 1 = 7
    with pytest.raises(ValueError, match="max_new"):
        server.submit(np.zeros(3, np.int32), max_new=-1)
    server.submit(np.zeros(7, np.int32))  # exactly full cache: accepted


def test_priority_class_admitted_first(tiny):
    cfg, params = tiny
    server = ContinuousBatchingServer(cfg, params, max_slots=1, max_len=16, **CPU)
    prompt = _prompts(cfg, 1)[0]
    low = server.submit(prompt, max_new=1, priority=PRIORITY_LOW)
    normal = server.submit(prompt, max_new=1)
    high = server.submit(prompt, max_new=1, priority=PRIORITY_HIGH)
    assert server._pick_next() is high
    assert server._pick_next() is normal
    assert server._pick_next() is low


def test_tenant_fairness_oldest_first_tiebreak(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE)
    a = [server.submit(p, max_new=2, tenant="A") for p in _prompts(cfg, 4, seed=4)]
    b = server.submit(_prompts(cfg, 1, seed=5)[0], max_new=2, tenant="B")
    server.run_until_drained()
    server.close()
    assert b.t_admit < a[2].t_admit < a[3].t_admit


def test_preempted_tokens_bit_identical_to_unpreempted(tiny):
    cfg, params = tiny
    p = _prompts(cfg, 2, seed=9)

    def run(preempt_rounds):
        server = SessionServer(cfg, params, max_slots=1, max_len=32,
                               preempt_rounds=preempt_rounds, **WAVE)
        flood = server.submit(p[0], max_new=10, priority=PRIORITY_LOW)
        server.pump()
        high = server.submit(p[1], max_new=2, priority=PRIORITY_HIGH)
        done = server.run_until_drained()
        server.close()
        done += server.pump()
        by = {r.rid: r for r in done}
        return by[flood.rid], by[high.rid], server

    flood_p, high_p, server_p = run(preempt_rounds=2)
    flood_n, high_n, _ = run(preempt_rounds=None)
    assert server_p.preemptions >= 1 and flood_p.preemptions >= 1
    assert flood_n.preemptions == 0
    assert high_p.t_finish < flood_p.t_finish
    assert flood_p.generated == flood_n.generated and len(flood_p.generated) == 10
    assert high_p.generated == high_n.generated


@pytest.mark.parametrize("server_cls", [SessionServer, ContinuousBatchingServer])
def test_zero_rounds_finish_on_prefill(tiny, server_cls):
    cfg, params = tiny
    server = server_cls(cfg, params, max_slots=2, max_len=32, **CPU)
    req = server.submit(_prompts(cfg, 1)[0], max_new=0)
    done = server.run_until_drained()
    if server_cls is SessionServer:
        server.close()
    assert [r.rid for r in done] == [req.rid] and req.generated == []
    assert _no_prompt_buffers(server.pool)


def test_close_drains_inflight_chains(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE)
    req = server.submit(_prompts(cfg, 1, seed=9)[0], max_new=2)
    server.pump()
    server.close()
    assert [r.rid for r in server.pump()] == [req.rid]
    assert len(req.generated) == 2


def test_stalled_session_raises_drain_timeout(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=1, max_len=16, **WAVE)
    server.submit(_prompts(cfg, 1)[0], max_new=2)
    server.submit(_prompts(cfg, 2)[1], max_new=2)
    server.session.poll = lambda: []
    server.session.drive = lambda: []
    with pytest.raises(DrainTimeout) as ei:
        server.run_until_drained(max_iters=5)
    assert (ei.value.active_slots, ei.value.queue_depth) == (1, 1)


@pytest.mark.parametrize("scheduler", ["mesh"])
def test_unported_schedulers_raise(tiny, scheduler):
    """Every scheduler of the reference is ported (the mesh last): it
    builds, the default is the reference's ``"frontier"``, and a name
    neither package has raises."""
    cfg, params = tiny
    assert SessionServer(cfg, params, scheduler=scheduler, **CPU).scheduler_name == scheduler
    assert SessionServer(cfg, params, **CPU).scheduler_name == "frontier"
    assert SessionServer.SCHEDULERS == ("frontier", "wave", "device", "mesh")
    with pytest.raises(ValueError, match="scheduler"):
        SessionServer(cfg, params, scheduler="teleport", **CPU)


@pytest.mark.parametrize("plan_mode", [None, "wave", "frontier"])
@pytest.mark.parametrize("key", SERVED)
def test_device_server_matches_wave_server_and_greedy_loop(key, plan_mode):
    """The device server (its default plan mode is the reference's "loop")
    gives the wave server's tokens and the plain greedy loop's. Every
    serving task has opaque slot values, so every one takes the device
    session's in-epoch host path."""
    cfg, params = _model(key)
    prompts = _prompts(cfg, 5, seed=1, length=7)
    mode = {} if plan_mode is None else {"plan_mode": plan_mode}
    device = SessionServer(cfg, params, max_slots=2, max_len=32, scheduler="device", **mode,
                           **CPU)
    assert device.session.plan_mode == (plan_mode or "loop")
    got = _serve(device, prompts, 3)
    wave = _serve(SessionServer(cfg, params, max_slots=2, max_len=32, **WAVE), prompts, 3)
    assert got == wave
    for p in prompts:
        assert got[tuple(p)] == _greedy(cfg, params, p, 3, 32)
    stats = device.session.session_stats()
    assert stats["device_dispatches"] == 0
    assert stats["host_task_dispatches"] == len(prompts) * (1 + 3)
    assert device.host_reads == 3 * len(prompts)
    assert _no_prompt_buffers(device.pool)


def test_device_server_frees_prompt_rows_through_the_pool_hook(tiny):
    cfg, params = tiny
    server = SessionServer(cfg, params, max_slots=2, max_len=32, scheduler="device", **CPU)
    hooks = server.pool._free_hooks
    real = server.session.release_buffer
    assert real in hooks
    released = []
    hooks[hooks.index(real)] = lambda buf: (released.append(buf.name), real(buf))
    _serve(server, _prompts(cfg, 3), 2)
    assert len(released) == 3 and all(n.endswith("_prompt") for n in released)


@pytest.mark.parametrize("key", ["recurrentgemma", "falcon_mamba"])
def test_fresh_admission_resets_a_reused_slots_recurrent_state(key):
    """One slot serves two requests in turn: when the second is admitted,
    the slot's recurrent states and conv tails are zero again (the first
    request left them non-zero), and its tokens are the greedy loop's from
    a fresh cache. (The reference keeps the old state; ROADMAP queue 3.)"""
    cfg, params = _model(key)
    first, second = _prompts(cfg, 2, seed=11, length=7)
    server = SessionServer(cfg, params, max_slots=1, max_len=32, **WAVE)
    _serve(server, [first], 3)

    def recurrent(cache):
        entries = list(cache["prefix"]) + [e for stage in cache["stages"] for e in stage]
        kinds = list(cfg.pattern[: len(cache["prefix"])]) + list(cfg.pattern_unit) * len(
            cache["stages"])
        return [t for e, kind in zip(entries, kinds) if kind in ("rglru", "mamba") for t in e]

    stale = recurrent(server.slots[0].value[0])
    assert stale and all(bool(t.abs().sum() > 0) for t in stale)
    req = server.submit(second, max_new=3)
    server._pick_next()
    server._grant_slot(req)
    assert all(not bool(t.abs().sum() > 0) for t in recurrent(server.slots[0].value[0]))

    again = SessionServer(cfg, params, max_slots=1, max_len=32, **WAVE)
    got = _serve(again, [first, second], 3)
    assert got[tuple(second)] == _greedy(cfg, params, second, 3, 32)


@pytest.mark.parametrize("server_cls", [SessionServer, ContinuousBatchingServer])
@pytest.mark.parametrize("name", ["musicgen-large", "paligemma-3b"])
def test_servers_refuse_frontend_archs(name, server_cls):
    cfg = ARCHS[name].reduced()
    params = init_params(cfg, 0, **CPU)
    with pytest.raises(ValueError, match="token models"):
        server_cls(cfg, params, max_slots=1, max_len=16, **CPU)


@pytest.mark.parametrize("kind", ["batch", "wave", "frontier", "device"])
def test_deleted_server_frees_its_model_without_the_collector(kind):
    """A served and closed server holds no reference cycle to its model: once
    the caller drops both, the weights are freed at once, with the garbage
    collector off (a card's memory pressure never runs the collector, so a
    cycle kept the previous model resident when the next was drawn)."""
    cfg = _model("danube")[0]
    params = init_params(cfg, 0, **CPU)
    if kind == "batch":
        server = ContinuousBatchingServer(cfg, params, max_slots=2, max_len=32, **CPU)
    else:
        server = SessionServer(cfg, params, max_slots=2, max_len=32, scheduler=kind, **CPU)
    assert len(_serve(server, _prompts(cfg, 3, seed=2), 2)) == 3
    held = weakref.ref(params)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del server, params
        assert held() is None
    finally:
        if enabled:
            gc.enable()

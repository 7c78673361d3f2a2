"""The reference's multi-tenant QoS tests (``tests/test_qos.py``, its 20
tests) held against the port on the CPU, with ``"device"`` and ``"mesh"``
where the reference parametrises them. Each scenario runs on a tiny
danube in both packages (the reference's weights carried across by
``params_from_numpy``) and must give the same structure in both: the
admission order (requests named by submission index), the errors and
their counts, the drain-timeout counts, the preemption counts and every
request's token count. The reference's own assertions are held on the
port. Token values are compared inside the port only (preempted against
unpreempted), as ``tests/test_torch_serve.py`` does: the two packages'
models are held by their logits in ``tests/test_torch_models.py``.

Scenarios whose outcome depends on the wall clock (deadlines, aging) are
held to the reference's assertions in each package, not to each other."""

import dataclasses
import functools
import time

import jax
import numpy as np
import pytest

import repro.runtime as RR
import repro_torch.runtime as TR
from repro.configs import ARCHS as R_ARCHS
from repro.models import init_params as r_init_params
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import params_from_numpy

SIDES = ("ref", "port")
RUNTIME = {"ref": RR, "port": TR}


def _tiny(archs):
    cfg = archs["h2o-danube-3-4b"].reduced()
    return dataclasses.replace(cfg, n_layers=1, d_model=32, d_ff=64, vocab=64, n_heads=2,
                               n_kv_heads=1, head_dim=16)


@functools.lru_cache(maxsize=None)
def _model(side):
    cfg = _tiny(R_ARCHS)
    ref = r_init_params(cfg, jax.random.PRNGKey(0), tp_size=1)
    if side == "ref":
        return cfg, ref
    tcfg = _tiny(T_ARCHS)
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, ref), tcfg, device="cpu")


def server(side, kind="SessionServer", **kw):
    cfg, params = _model(side)
    if side == "port":
        kw["device"] = "cpu"
    return getattr(RUNTIME[side], kind)(cfg, params, **kw)


def prompts(n, seed=0, length=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, length) for _ in range(n)]


def both(run):
    got = {side: run(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def index_of(reqs):
    """rid -> submission index (rids differ between the packages)."""
    return {r.rid: i for i, r in enumerate(reqs)}


# -- Request.latency before finish ----------------------------------------------

class TestLatencyPreFinish:
    def test_latency_is_none_until_finished(self):
        def run(side):
            req = RUNTIME[side].Request(prompt=np.array([1, 2, 3], np.int32))
            req.t_arrival = time.perf_counter()
            before = (req.finished, req.latency)
            req.t_finish = req.t_arrival + 0.25
            return before, req.finished, req.latency == pytest.approx(0.25)

        assert both(run) == ((False, None), True, True)

    def test_queued_and_active_requests_report_none(self):
        def run(side):
            s = server(side, max_slots=1, max_len=16)
            reqs = [s.submit(p, max_new=2) for p in prompts(3, seed=4)]
            s.pump()  # one admitted (active), two queued
            pending = [r.latency for r in reqs]
            done = s.run_until_drained()
            s.close()
            assert all(r.latency is not None and r.latency > 0 for r in done)
            assert float(np.percentile([r.latency for r in done], 99)) > 0
            return pending, sorted(index_of(reqs)[r.rid] for r in done)

        assert both(run) == ([None] * 3, [0, 1, 2])


# -- run_until_drained exhaustion -----------------------------------------------

class TestDrainTimeout:
    def test_session_server_raises_on_stalled_session(self):
        def run(side):
            s = server(side, max_slots=1, max_len=16)
            s.submit(prompts(1)[0], max_new=2)
            s.submit(prompts(2)[1], max_new=2)
            s.session.poll = lambda: []
            s.session.drive = lambda: []
            with pytest.raises(RUNTIME[side].DrainTimeout) as ei:
                s.run_until_drained(max_iters=5)
            return (ei.value.active_slots, ei.value.queue_depth, ei.value.finished,
                    "5" in str(ei.value))

        assert both(run) == (1, 1, [], True)

    def test_batch_server_raises_when_steps_exhaust(self):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=1, max_len=16)
            s.submit(prompts(1)[0], max_new=2)
            s.step = lambda: []
            with pytest.raises(RUNTIME[side].DrainTimeout) as ei:
                s.run_until_drained(max_iters=3)
            return ei.value.queue_depth, ei.value.active_slots

        assert both(run) == (1, 0)

    def test_healthy_drain_does_not_raise(self):
        def run(side):
            s = server(side, max_slots=2, max_len=16)
            s.submit(prompts(1)[0], max_new=2)
            done = s.run_until_drained()
            s.close()
            return [len(r.generated) for r in done]

        assert both(run) == [2]


# -- _pick_next: incremental counts reproduce the old scan ----------------------

def _old_pick_rid(queue, active):
    counts = {}
    for r in active.values():
        counts[r.tenant] = counts.get(r.tenant, 0) + 1
    best, best_load = 0, counts.get(queue[0].tenant, 0)
    for i in range(1, len(queue)):
        load = counts.get(queue[i].tenant, 0)
        if load < best_load:
            best, best_load = i, load
    return queue[best].rid


class TestPickNextEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_property_choice_unchanged_vs_old_scan(self, seed):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=4, max_len=16,
                       max_queue=64)
            rng = np.random.RandomState(seed)
            tenants = ["alpha", "beta", "gamma"]
            prompt = prompts(1, seed=seed)[0]
            submitted, picks = [], []
            for _ in range(120):
                r = rng.rand()
                if r < 0.45 and len(s.queue) < s.max_queue:
                    submitted.append(s.submit(prompt, max_new=1,
                                              tenant=tenants[rng.randint(len(tenants))]))
                elif r < 0.8 and s.queue and s.free:
                    want = _old_pick_rid(s.queue, s.active)
                    req = s._pick_next()
                    assert req is not None and req.rid == want
                    s._grant_slot(req)
                    s.pool.free(f"req{req.rid}_prompt")
                    picks.append(index_of(submitted)[req.rid])
                elif s.active:
                    slot = list(s.active)[rng.randint(len(s.active))]
                    s._release_slot(slot)
            return picks

        assert len(both(run)) >= 10

    def test_incremental_counts_track_active_exactly(self):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=3, max_len=16)
            for t in ("a", "a", "b"):
                s.submit(prompts(1)[0], max_new=1, tenant=t)
            while s.queue and s.free:
                s._grant_slot(s._pick_next())
            counts = dict(s._tenant_active)
            for slot in list(s.active):
                s._release_slot(slot)
            return counts, dict(s._tenant_active)

        assert both(run) == ({"a": 2, "b": 1}, {})


# -- QoS admission: priorities, weights, quotas, deadlines ----------------------

class TestQosAdmission:
    def test_priority_class_admitted_first(self):
        def run(side):
            rt = RUNTIME[side]
            s = server(side, "ContinuousBatchingServer", max_slots=1, max_len=16)
            p = prompts(1)[0]
            reqs = [s.submit(p, max_new=1, priority=rt.PRIORITY_LOW), s.submit(p, max_new=1),
                    s.submit(p, max_new=1, priority=rt.PRIORITY_HIGH)]
            return [index_of(reqs)[s._pick_next().rid] for _ in range(3)]

        assert both(run) == [2, 1, 0]

    def test_weighted_shares_hold_proportional_slots(self):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=3, max_len=16,
                       tenant_weights={"heavy": 2.0})
            for t in ("heavy", "light", "heavy", "light", "heavy", "light"):
                s.submit(prompts(1)[0], max_new=1, tenant=t)
            while s.queue and s.free:
                s._grant_slot(s._pick_next())
            by_tenant = {}
            for r in s.active.values():
                by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
            return by_tenant

        assert both(run) == {"heavy": 2, "light": 1}

    def test_quota_caps_active_slots_and_never_drops(self):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=3, max_len=16,
                       tenant_quota={"flood": 1})
            floods = [s.submit(prompts(1)[0], max_new=1, tenant="flood") for _ in range(4)]
            while s.queue and s.free:
                req = s._pick_next()
                if req is None:
                    break
                s._grant_slot(req)
            held = (len(s.active), len(s.queue), s._pick_next() is None)
            s._release_slot(floods[0].slot)
            return held, index_of(floods)[s._pick_next().rid]

        assert both(run) == ((1, 3, True), 1)

    def test_quota_respected_through_full_serve(self):
        def run(side):
            s = server(side, "ContinuousBatchingServer", max_slots=2, max_len=16,
                       tenant_quota={"flood": 1})
            for p in prompts(4, seed=5):
                s.submit(p, max_new=1, tenant="flood")
            done = []
            for _ in range(40):
                done.extend(s.step())
                assert sum(1 for r in s.active.values() if r.tenant == "flood") <= 1
                if not s.queue and not s.active:
                    break
            return len(done)

        assert both(run) == 4

    def test_deadline_promotion_beats_arrival_order(self):
        for side in SIDES:
            rt = RUNTIME[side]
            s = server(side, "ContinuousBatchingServer", max_slots=1, max_len=16)
            older = s.submit(prompts(1)[0], max_new=1)
            urgent = s.submit(prompts(1)[0], max_new=1, deadline=0.002)
            time.sleep(0.005)  # more than half the deadline budget is gone
            assert s.effective_priority(urgent) == rt.PRIORITY_HIGH
            assert s._pick_next() is urgent
            assert s._pick_next() is older

    def test_submit_validates_qos_fields(self):
        for side in SIDES:
            s = server(side, "ContinuousBatchingServer", max_slots=1, max_len=16)
            with pytest.raises(ValueError, match="priority"):
                s.submit(prompts(1)[0], priority=-1)
            with pytest.raises(ValueError, match="deadline"):
                s.submit(prompts(1)[0], deadline=0.0)
            with pytest.raises(ValueError, match="weight"):
                server(side, "ContinuousBatchingServer", max_slots=1, max_len=16,
                       tenant_weights={"x": 0.0})
            with pytest.raises(ValueError, match="aging_s"):
                server(side, "ContinuousBatchingServer", max_slots=1, max_len=16, aging_s=-1.0)
            with pytest.raises(ValueError, match="preempt_rounds"):
                server(side, max_slots=1, max_len=16, preempt_rounds=0)

    def test_aged_request_ties_but_never_outranks_fresh_high(self):
        for side in SIDES:
            rt = RUNTIME[side]
            s = server(side, "ContinuousBatchingServer", max_slots=1, max_len=16,
                       aging_s=0.001)
            aged = s.submit(prompts(1)[0], max_new=1, priority=rt.PRIORITY_LOW)
            time.sleep(0.01)  # ages far past bucket 0
            assert s.effective_priority(aged) == rt.PRIORITY_HIGH


# -- the starvation bound under a one-tenant flood ------------------------------

class TestFloodFairness:
    @pytest.mark.parametrize("scheduler", ["device", "mesh"])
    def test_flood_cannot_starve_quiet_tenant_beyond_aging_bound(self, scheduler):
        def run(side):
            rt = RUNTIME[side]
            s = server(side, max_slots=2, max_len=16, scheduler=scheduler, aging_s=0.02)
            flood = [s.submit(p, max_new=3, tenant="flood", priority=rt.PRIORITY_HIGH)
                     for p in prompts(10, seed=6)]
            quiet = s.submit(prompts(1, seed=7)[0], max_new=2, tenant="quiet",
                             priority=rt.PRIORITY_LOW)
            done = s.run_until_drained()
            s.close()
            assert quiet.t_admit < max(f.t_admit for f in flood), (
                "quiet tenant was starved until the entire flood drained")
            return len(done), len(quiet.generated)

        assert both(run) == (11, 2)

    def test_without_aging_strict_priority_starves_until_flood_drains(self):
        def run(side):
            rt = RUNTIME[side]
            s = server(side, max_slots=2, max_len=16, scheduler="frontier", aging_s=None)
            flood = [s.submit(p, max_new=3, tenant="flood", priority=rt.PRIORITY_HIGH)
                     for p in prompts(6, seed=6)]
            quiet = s.submit(prompts(1, seed=7)[0], max_new=2, tenant="quiet",
                             priority=rt.PRIORITY_LOW)
            s.run_until_drained()
            s.close()
            order = sorted(flood + [quiet], key=lambda r: r.t_admit)
            return index_of(flood + [quiet])[order[-1].rid]

        assert both(run) == 6  # the quiet request is admitted last


# -- cooperative preemption at segment and epoch boundaries ---------------------

def _preempt_run(side, scheduler, preempt_rounds, seed=8):
    rt = RUNTIME[side]
    s = server(side, max_slots=1, max_len=32, scheduler=scheduler,
               preempt_rounds=preempt_rounds)
    p = prompts(2, seed=seed)
    flood = s.submit(p[0], max_new=10, priority=rt.PRIORITY_LOW)
    s.pump()  # flood takes the only slot
    high = s.submit(p[1], max_new=2, priority=rt.PRIORITY_HIGH)
    done = s.run_until_drained()
    s.close()
    done += s.pump()
    by = {r.rid: r for r in done}
    return by[flood.rid], by[high.rid], s


class TestPreemption:
    @pytest.mark.parametrize("scheduler", ["frontier", "device", "mesh"])
    def test_flood_chain_yields_slot_to_high_priority(self, scheduler):
        def run(side):
            flood, high, s = _preempt_run(side, scheduler, 2)
            assert flood.preemptions >= 1 and s.preemptions >= 1
            assert high.t_finish < flood.t_finish
            return len(flood.generated), len(high.generated), flood.preemptions

        assert both(run)[:2] == (10, 2)

    def test_preempted_tokens_bit_identical_to_unpreempted(self):
        def run(side):
            flood_p, high_p, s_p = _preempt_run(side, "frontier", 2, seed=9)
            flood_n, high_n, _ = _preempt_run(side, "frontier", None, seed=9)
            assert s_p.preemptions >= 1
            assert flood_p.generated == flood_n.generated
            assert high_p.generated == high_n.generated
            return flood_p.preemptions >= 1, flood_n.preemptions

        assert both(run) == (True, 0)

    def test_no_preemption_between_equal_priorities(self):
        def run(side):
            s = server(side, max_slots=1, max_len=16, scheduler="frontier", preempt_rounds=1)
            reqs = [s.submit(x, max_new=3) for x in prompts(3, seed=10)]
            done = s.run_until_drained()
            s.close()
            done += s.pump()
            return len(done), s.preemptions, [r.preemptions for r in reqs]

        assert both(run) == (3, 0, [0, 0, 0])

    def test_close_drains_segmented_chains(self):
        def run(side):
            s = server(side, max_slots=2, max_len=16, scheduler="frontier", preempt_rounds=1)
            reqs = [s.submit(x, max_new=4) for x in prompts(3, seed=11)]
            s.pump()  # admitted: chains in flight, segments pending
            s.close()
            done = s.pump()
            return (sorted(index_of(reqs)[r.rid] for r in done),
                    [len(r.generated) for r in done])

        assert both(run) == ([0, 1, 2], [4, 4, 4])

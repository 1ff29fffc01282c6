"""The port's copies of the paper's characterization models against the
reference: the §6/§7.1 fleet simulator (``core/dpp/simulator.py``), the §4
collaborative-release simulator (``core/coordination.py``) and the §7.3
co-location scheduler (``core/scheduler.py``).  Both packages run the
same numpy code, so every result is compared for equality, over the
``WORKLOADS`` x ``NODE_SPECS`` grid and a few seeds."""
import dataclasses

import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.core import coordination as jcoord  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.dpp import simulator as jsim  # noqa: E402
from repro_torch.core import coordination as pcoord  # noqa: E402
from repro_torch.core import scheduler as psched  # noqa: E402
from repro_torch.core.dpp import simulator as psim  # noqa: E402


def _d(x):
    return dataclasses.asdict(x)


def test_constants_equal():
    assert {k: _d(v) for k, v in psim.NODE_SPECS.items()} == \
        {k: _d(v) for k, v in jsim.NODE_SPECS.items()}
    assert {k: _d(v) for k, v in psim.WORKLOADS.items()} == \
        {k: _d(v) for k, v in jsim.WORKLOADS.items()}
    assert psim.CPU_GHZ == jsim.CPU_GHZ
    assert _d(psim.TrainerFrontend()) == _d(jsim.TrainerFrontend())
    assert _d(psim.PowerSpec()) == _d(jsim.PowerSpec())
    assert _d(psim.CacheTierSpec(0.4)) == _d(jsim.CacheTierSpec(0.4))
    for name in psim.WORKLOADS:
        assert psim.WORKLOADS[name].kqps_ratio == jsim.WORKLOADS[name].kqps_ratio
    for name in psim.NODE_SPECS:
        p, j = psim.NODE_SPECS[name], jsim.NODE_SPECS[name]
        assert (p.mem_bw_per_core, p.nic_bw_per_core_gbps) == \
            (j.mem_bw_per_core, j.nic_bw_per_core_gbps)


@pytest.mark.parametrize("node", sorted(jsim.NODE_SPECS))
@pytest.mark.parametrize("workload", sorted(jsim.WORKLOADS))
def test_worker_throughput_and_workers_per_trainer(workload, node):
    pw, pn = psim.WORKLOADS[workload], psim.NODE_SPECS[node]
    jw, jn = jsim.WORKLOADS[workload], jsim.NODE_SPECS[node]
    assert _d(psim.worker_throughput(pw, pn)) == _d(jsim.worker_throughput(jw, jn))
    assert psim.workers_per_trainer(pw, pn) == jsim.workers_per_trainer(jw, jn)


@pytest.mark.parametrize("split_scoped,stripe_aligned",
                         [(True, True), (True, False), (False, True), (False, False)])
def test_split_over_read_amplification(split_scoped, stripe_aligned):
    for rows, per_split, stripe in [(8192, 512, 512), (10_000, 700, 512), (1, 1, 0),
                                    (4096, 1000, 300), (0, 64, 128)]:
        args = (rows, per_split, stripe, split_scoped, stripe_aligned)
        assert psim.split_over_read_amplification(*args) == \
            jsim.split_over_read_amplification(*args)


def test_trainer_loading_utilization():
    fe = dict(cores=32, nic_gbps=100.0, mem_bw_gbps=90.0)
    for gbps in (0.5, 5.0, 16.5, 40.0):
        assert psim.trainer_loading_utilization(gbps) == \
            jsim.trainer_loading_utilization(gbps)
        assert psim.trainer_loading_utilization(gbps, psim.TrainerFrontend(**fe)) == \
            jsim.trainer_loading_utilization(gbps, jsim.TrainerFrontend(**fe))


@pytest.mark.parametrize("workload", sorted(jsim.WORKLOADS))
def test_colocated_preprocessing_stall(workload):
    pw, jw = psim.WORKLOADS[workload], jsim.WORKLOADS[workload]
    for scale in (0.19, 0.05, 1.0):
        assert psim.colocated_preprocessing_stall(pw, demand_scale=scale) == \
            jsim.colocated_preprocessing_stall(jw, demand_scale=scale)


@pytest.mark.parametrize("hit_frac", [None, 0.0, 0.6])
@pytest.mark.parametrize("workload", sorted(jsim.WORKLOADS))
def test_dsi_power_split(workload, hit_frac):
    pw, jw = psim.WORKLOADS[workload], jsim.WORKLOADS[workload]
    for node in sorted(jsim.NODE_SPECS):
        for n_trainers, amp in ((16, 1.0), (3, 1.7)):
            pc = None if hit_frac is None else psim.CacheTierSpec(hit_frac)
            jc = None if hit_frac is None else jsim.CacheTierSpec(hit_frac)
            got = psim.dsi_power_split(pw, n_trainers, psim.NODE_SPECS[node],
                                       storage_amplification=amp, cache=pc)
            want = jsim.dsi_power_split(jw, n_trainers, jsim.NODE_SPECS[node],
                                        storage_amplification=amp, cache=jc)
            assert got == want


def _release_cfgs(seed):
    return [dict(days=60, seed=seed),
            dict(days=45, seed=seed, n_models=4, n_regions=3, kill_rate=0.5,
                 combo_window_days=5, release_period_days=15)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_release_simulator_and_its_reports(seed):
    for kw in _release_cfgs(seed):
        pjobs = pcoord.simulate(pcoord.ReleaseProcessConfig(**kw))
        jjobs = jcoord.simulate(jcoord.ReleaseProcessConfig(**kw))
        assert [_d(j) for j in pjobs] == [_d(j) for j in jjobs]
        putil = pcoord.daily_utilization(pjobs, kw["days"])
        jutil = jcoord.daily_utilization(jjobs, kw["days"])
        assert putil.tolist() == jutil.tolist()
        assert pcoord.utilization_peak_to_mean(putil) == jcoord.utilization_peak_to_mean(jutil)
        assert pcoord.regional_demand(pjobs) == jcoord.regional_demand(jjobs)
        assert pcoord.combo_duration_skew(pjobs) == jcoord.combo_duration_skew(jjobs)
    assert pcoord.combo_duration_skew([]) == jcoord.combo_duration_skew([])


def _placement(p):
    return (p.model_regions, p.region_load, p.region_peak)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_scheduler_matches_reference(seed):
    for kw in _release_cfgs(seed):
        pjobs = pcoord.simulate(pcoord.ReleaseProcessConfig(**kw))
        jjobs = jcoord.simulate(jcoord.ReleaseProcessConfig(**kw))
        sizes = {"MA": 3.0, "MB": 0.5}
        pd = psched.demands_from_release_sim(pjobs, sizes)
        jd = jsched.demands_from_release_sim(jjobs, sizes)
        assert [_d(d) for d in pd] == [_d(d) for d in jd]
        peak = sum(d.peak_compute for d in jd)
        for n_regions, cap in ((5, peak), (4, peak / 3)):
            pr = [psched.Region(f"R{i}", capacity=cap, storage_pb=1e3)
                  for i in range(n_regions)]
            jr = [jsched.Region(f"R{i}", capacity=cap, storage_pb=1e3)
                  for i in range(n_regions)]
            pbase, jbase = psched.replicate_everywhere(pd, pr), jsched.replicate_everywhere(jd, jr)
            assert _placement(pbase) == _placement(jbase)
            for min_replicas, headroom in ((2, 0.9), (3, 0.7), (1, 1.0)):
                pp = psched.greedy_colocate(pd, pr, min_replicas, headroom)
                jp = jsched.greedy_colocate(jd, jr, min_replicas, headroom)
                assert _placement(pp) == _placement(jp)
                assert [pp.replicas(d.name) for d in pd] == [jp.replicas(d.name) for d in jd]
                assert psched.replication_report(pd, pbase, pp) == \
                    jsched.replication_report(jd, jbase, jp)

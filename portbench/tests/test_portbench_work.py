"""The yardstick's arithmetic: the frozen kernel counts against the
program's, the iteration's FLOPs against a hand count, and the idle and
launch arithmetic of the trace on synthetic intervals."""
import pytest

from portbench import spec, trace, work


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_frozen_work_equals_the_programs(cell):
    from walk_these_ways_tpu_torch import go1_config
    from walk_these_ways_tpu_torch.models.robot import go1
    from walk_these_ways_tpu_torch.ops import megastep
    c = spec.load_cell(cell)
    cfg = getattr(go1_config, c.config["env_cfg"])(
        num_envs=int(c.traffic["num_envs"]))
    assert cfg.sim.num_contact_iters_warm == c.config["kernel"]["warm_iters"]
    assert cfg.sim.num_contact_iters == c.config["kernel"]["num_iters"]
    assert cfg.control.decimation == c.config["decimation"]
    k = c.config["kernel"]
    ref = megastep.work_per_env(
        go1(), c.config["decimation"], k["warm_iters"],
        hidden=k["actuator_hidden"], features=k["actuator_features"],
        control_type=k["control_type"], exact=k["exact"],
        num_iters=k["num_iters"], flat=k["flat"], entry=k["entry"])
    n = int(c.traffic["num_envs"])
    assert work.kernel_work(c.config, n) == (ref[0] * n, ref[1] * n)
    # the other variants too, so that the frozen copy is whole
    for kw in (dict(entry=False), dict(exact=True), dict(flat=False),
               dict(control_type="P", entry=True)):
        assert work.work_per_env(go1(), 4, 3, **kw) == \
            megastep.work_per_env(go1(), 4, 3, **kw)


def test_least_time_says_its_bound():
    t, bound = work.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and bound == "bytes"
    t, bound = work.least_seconds(1.0, 67e12)
    assert t == pytest.approx(1.0) and bound == "operations"


def test_iteration_flops_match_a_hand_count():
    cfg = dict(algo="cse", decimation=4,
               networks=dict(adaptation=[4, 3, 2], actor=[6, 5, 2],
                             critic=[6, 5, 1]),
               ppo=dict(num_learning_epochs=2),
               kernel=dict(control_type="P", actuator_hidden=32,
                           actuator_features=6, warm_iters=3, num_iters=16,
                           exact=False, flat=True, entry=True))
    n, steps = 3, 2
    # forward FLOPs per sample: 2 * sum(in * out)
    fa, fp, fc = 2 * (4 * 3 + 3 * 2), 2 * (6 * 5 + 5 * 2), 2 * (6 * 5 + 5)
    rollout = n * steps * (fa + fp + fc) + n * fc
    # backward: weight grads of every layer; input grads where needed
    bc = 2 * (6 * 5 + 5) + 2 * 5            # critic, input is data
    bp = 2 * (6 * 5 + 5 * 2) * 2            # actor, input holds the latent
    ba = 2 * (4 * 3 + 3 * 2) + 2 * 3 * 2    # adaptation, input is data
    per = fa + fp + fc + bc + bp + ba + fa + ba
    update = 2 * n * steps * per
    got = work.iteration_flops(cfg, n, steps)
    assert got["rollout"] == rollout
    assert got["update"] == update
    assert got["kernel"] == steps * work.kernel_work(cfg, n)[1]
    assert got["total"] == rollout + update + got["kernel"]


def test_iteration_flops_rma_hand_count():
    cfg = dict(algo="rma", decimation=4,
               networks=dict(encoder=[2, 3, 2], adaptation=[4, 3, 2],
                             actor=[5, 4, 2], critic=[5, 4, 1]),
               ppo=dict(num_learning_epochs=1),
               kernel=dict(control_type="P", actuator_hidden=32,
                           actuator_features=6, warm_iters=3, num_iters=16,
                           exact=False, flat=True, entry=True))
    fe, fa = 2 * (2 * 3 + 3 * 2), 2 * (4 * 3 + 3 * 2)
    fp, fc = 2 * (5 * 4 + 4 * 2), 2 * (5 * 4 + 4)
    rollout = 1 * 1 * (2 * fe + fp + fc) + (fe + fc)
    be = 2 * (2 * 3 + 3 * 2) + 2 * 3 * 2
    ba = 2 * (4 * 3 + 3 * 2) + 2 * 3 * 2
    bp, bc = 2 * 2 * (5 * 4 + 4 * 2), 2 * 2 * (5 * 4 + 4)
    per = 2 * fe + fp + fc + bp + bc + 2 * be + fe + fa + ba
    got = work.iteration_flops(cfg, 1, 1)
    assert got["rollout"] == rollout and got["update"] == per


def _profile(device, ranges):
    return dict(device=sorted(device), host=[], ranges=ranges)


def test_idle_arithmetic_on_synthetic_intervals():
    # window [0, 100]; device busy [10, 30] u [20, 40] u [60, 70] = 40
    p = _profile([(10, 30, "a"), (20, 40, "b"), (60, 70, "a"),
                  (95, 120, "c")],
                 {trace.ITERATION: [(0, 50), (50, 100)]})
    w = trace.window_summary(p)
    assert w["window_s"] == pytest.approx(100e-9)
    assert w["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-9)
    assert w["gaps"] == [(0, 10), (40, 60), (70, 95)]
    idle = spec.reader("device.idle")(dict(window=w))
    assert idle == pytest.approx(55.0)
    # only the ops that lie wholly in the window count by name
    assert w["by_name"] == {"a": pytest.approx(30e-9),
                            "b": pytest.approx(20e-9)}


def test_launches_and_roofline_readers():
    c = spec.load_cell("cse_flat_4000")
    name = c.config["kernel"]["name"]
    dev = [(100, 110, "elementwise"), (120, 130, f"void {name}<true>"),
           (140, 150, "gemm"), (300, 310, "gemm")]
    p = _profile(dev, {trace.ROLLOUT: [(90, 200)],
                       trace.ITERATION: [(0, 400)]})
    w = trace.window_summary(p)
    n_envs = int(c.traffic["num_envs"])
    ctx = dict(cell=c, profile=p, window=w,
               num_steps=int(c.traffic["num_steps_per_env"]),
               num_envs=n_envs, kernel_work=work.kernel_work(c.config,
                                                             n_envs))
    assert spec.reader("env.launches_per_step")(ctx) == pytest.approx(
        3 / ctx["num_steps"])
    least, _ = work.least_seconds(*ctx["kernel_work"])
    assert spec.reader("kernel.control_step_roofline")(ctx) == \
        pytest.approx(100 * least / 10e-9)
    none = dict(ctx, profile=_profile(dev[:1], p["ranges"]))
    assert spec.reader("kernel.control_step_roofline")(none) is None


def test_span_readers():
    ctx = dict(spans={trace.ROLLOUT: [0.4, 0.6], trace.UPDATE: [0.3],
                      trace.ITERATION: [1.0, 3.0]},
               flops=dict(total=67e12 * 0.5))
    assert spec.reader("learner.rollout_ms")(ctx) == pytest.approx(500.0)
    assert spec.reader("learner.update_ms")(ctx) == pytest.approx(300.0)
    assert spec.reader("iter_mfu")(ctx) == pytest.approx(25.0)
    assert spec.reader("learner.rollout_ms")(dict(spans={})) is None


def test_breakdown_labels_gaps_with_the_host_op():
    p = dict(device=[(10, 20, "k1"), (50, 60, "k2")],
             host=sorted([(0, 100, "aten::outer"), (25, 45, "aten::item"),
                          (30, 40, "cudaMemcpyAsync")]),
             ranges={trace.ITERATION: [(0, 100)]})
    w = trace.window_summary(p)
    b = trace.breakdown(p, w)
    labels = dict((n, v) for n, v in b["idle_gaps"])
    assert labels["aten::item > cudaMemcpyAsync"] == pytest.approx(30e-9)
    assert b["device_ops"][0][1] == pytest.approx(10e-9)
    # a gap in which no host op runs takes the harness's range it lies in
    p = dict(device=[(10, 20, "k1"), (50, 60, "k2")], host=[],
             ranges={trace.ITERATION: [(10, 60)], trace.ROLLOUT: [(0, 55)]})
    b = trace.breakdown(p, trace.window_summary(p))
    assert b["idle_gaps"] == [["host between ops in rollout",
                               pytest.approx(30e-9)]]


def test_parting_envs_are_left_out_up_to_their_share():
    import torch

    from portbench import check
    n = 4000
    ref = torch.zeros((n, 3))
    prog = ref.clone()
    prog[:, 0] += 1e-3                      # every env within rounding
    prog[7, 1] = 5.0                        # one env parts
    g = check.per_env_gap(prog, ref, 1.0, 0)
    assert g.shape == (n,) and float(g[7]) == 5.0
    assert check.parting_envs(g).tolist() == [7]
    assert check.all_but(g, check.parting_envs(g)) == pytest.approx(1e-3)
    prog[10, 2] = 5.0                       # two envs may part
    g = check.per_env_gap(prog, ref, 1.0, 0)
    assert check.all_but(g, check.parting_envs(g)) == pytest.approx(1e-3)
    prog[11, 2] = 5.0                       # three may not
    g = check.per_env_gap(prog, ref, 1.0, 0)
    assert check.all_but(g, check.parting_envs(g)) == 5.0
    # an env under the parting gap is never left out
    prog = ref.clone()
    prog[3, 0] = 5e-3
    g = check.per_env_gap(prog, ref, 1.0, 0)
    assert check.parting_envs(g).numel() == 0
    assert check.all_but(g, check.parting_envs(g)) == pytest.approx(5e-3)
    # the env axis last (env-minor impulses), and a non-finite value
    lam = torch.zeros((14, 3, n))
    bad = lam.clone()
    bad[2, 1, 9] = float("nan")
    g = check.per_env_gap(bad, lam, 1.0, -1)
    assert torch.isinf(g[9]) and float(g[8]) == 0.0
    assert check.parting_envs(g).numel() == 0
    assert check.all_but(g, check.parting_envs(g)) == float("inf")
    assert check.all_but(torch.zeros(16), torch.tensor([0, 1])) == 0.0

"""The yardstick's arithmetic: the chip's published peaks, the operations and
bytes of the control-step kernel (a frozen copy of the program's
`ops/megastep.work_per_env` and the counts it rests on), and the fp32 FLOPs
of one PPO iteration counted from the configuration's MLP widths."""
from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM (data sheet, dense): fp32 outside the tensor cores and
# HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# fp32 operations of one heightfield sample (csrc/wtw_device.cuh)
HEIGHTFIELD_SAMPLE_OPS = 47


# -- the control-step kernel ----------------------------------------------------


def point_dof_groups(anc_p):
    """Point runs that touch the base dofs and at most one contiguous joint
    range: [(p_lo, p_hi, dof_lo, dof_hi)], dof_lo None for base-only runs."""
    anc_p = np.asarray(anc_p).astype(bool)
    P, nv = anc_p.shape
    groups = []
    s = 0
    for p in range(1, P + 1):
        if p == P or (anc_p[p] != anc_p[s]).any():
            joint = np.nonzero(anc_p[s][6:])[0]
            if joint.size == 0:
                groups.append((s, p, None, None))
            else:
                lo, hi = 6 + int(joint[0]), 6 + int(joint[-1]) + 1
                groups.append((s, p, lo, hi))
            s = p
    merged = [groups[0]]
    for (s, p, lo, hi) in groups[1:]:
        ms, mp, mlo, mhi = merged[-1]
        if lo is not None and mlo is not None and \
                max(lo, mlo) < min(hi, mhi):
            merged[-1] = (ms, p, min(lo, mlo), max(hi, mhi))
        else:
            merged.append((s, p, lo, hi))
    return merged


def topology(model):
    anc = np.asarray(model.anc_dof_body).astype(bool)
    anc_p = anc[:, np.asarray(model.cp_body)].T
    return anc, anc_p, tuple(point_dof_groups(anc_p))


def dyn_ops(anc) -> int:
    """fp32 operations of one rigid-body dynamics evaluation."""
    anc = np.asarray(anc).astype(bool)
    nv, nb = anc.shape
    nj = nv - 6
    n_anc = int(anc.sum())
    n_janc = int(anc[6:].sum())
    return (2 * 6 * n_anc + nj * 3 * 9 + 6 * n_janc
            + nb * (4 * 15 + 2 * 18 + 3 * 9 + 12)
            + 12 * n_janc + 2 * nv * nv + nv + 9)


def solve_ops(jnz: int, P: int, nv: int, iters: int, warm: bool,
              flat: bool = True) -> int:
    """fp32 operations of one contact solve on `jnz` nonzero J entries."""
    minv = 2 * nv * nv
    row, tgt = (40, 10) if flat else (92, 15)
    sweep = 2 * jnz * 2 + P * row + minv
    return ((2 * jnz + P * tgt) + ((2 * jnz + minv) if warm else 0)
            + iters * sweep + (2 * jnz + 6 * P + nv))


def cache_rebuild_ops(model) -> int:
    """fp32 operations per env of one rebuild of the dynamics cache from the
    robot's static structure (FK, twists, inertia, CRBA, M^-1, points)."""
    nb, nj, nv = model.nb, model.nj, model.nv
    nz = np.count_nonzero

    def mv(k):
        return 3 * max(2 * k - 1, 0)

    ops = 9 + 21
    for a, an in zip(np.asarray(model.joint_axis, np.float64),
                     np.asarray(model.joint_anchor)):
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        terms = (np.eye(3) != 0).astype(int) + (K != 0) + (K @ K != 0)
        ops += 3 + nz(K) + nz(K @ K) + int(np.maximum(terms - 1, 0).sum())
        ops += mv(nz(an)) + 3 + mv(nz(a))
        ops += sum(mv(nz(col)) for col in (terms > 0).T)
    ops += 12 * nj
    ops += sum(mv(nz(c)) + 3 for c in np.asarray(model.com))
    ops += 1 + mv(3) + 3 + 1 + nz(model.inertia[0])
    for inertia in np.asarray(model.inertia).reshape(nb, 3, 3):
        ops += sum(mv(nz(row)) for row in inertia) + 45 + 3 + 6 + 15 + 9
    jb = np.asarray(model.joint_body)
    n_sub = np.asarray(model.anc_dof_body)[6:].sum(axis=1)
    ops += 19 * (nb - 1)
    ops += int(19 * (n_sub - 1).sum()) + 54 * nj
    ops += 11 * nz(np.asarray(model.subtree)[jb[:, None], jb[None, :]]) + nv
    inv3, legs = 49, nj // 3
    ops += legs * inv3 + 30 * nj + 72 * nj
    ops += 2 * inv3 + 4 * 45 + 9 + 54 + 9
    ops += 66 * nj + 6 * nj + 11 * nj * nj + 9 * legs
    ops += sum(mv(nz(o)) + 3 for o in np.asarray(model.cp_offset))
    return int(ops)


def work_per_env(model, decimation: int, warm_iters: int, hidden: int = 32,
                 features: int = 6, control_type: str = "actuator_net",
                 exact: bool = False, num_iters: int = 16, flat: bool = True,
                 entry: bool = False):
    """(bytes moved, fp32 operations) per env of one control step of the
    kernel variant: each input read once and each output written once, and
    the arithmetic with its static sparsity (a multiply-add counts 2).
    `entry`: the cache built in the launch from the entry state (K4, K4b,
    K4c, K4b-P)."""
    nv, nb = model.nv, model.nb
    nj = nv - 6
    P = model.cp_body.shape[0]
    D = decimation
    anc, anc_p, groups = topology(model)
    pctrl = control_type == "P"
    hist = 0 if pctrl else 4 * nj
    if exact:
        cache_in = 1 + 3
    elif entry:
        cache_in = 1 + 3 + P * 3
    else:
        cache_in = (2 * nv * 3 + 2 * nb * 9 + nb + nv * nv
                    + P * 3 + P * 3)
    if not flat:
        cache_in += P * 4 if entry else P * 3
    floats_in = (cache_in + P + 1 + 1 + 3 + 2 * nj + 3 + 4 + 3 + 3 + D * nj
                 + nj + (2 * nj if pctrl else hist))
    floats_out = 2 * nj + 3 + 4 + 3 + 3 + 3 * P * 3 + nj + hist
    nd = anc_p.sum(axis=1)
    jnz = int(3 * nd.sum())
    n_w = 4 if flat else 6
    cache = int(sum(3 * 2 * d * d + n_w * 2 * d for d in nd)) + 9 * jnz // 3
    if not flat:
        cache += 20 * P
    torque = 4 * nj if pctrl else (
        nj * 2 * (features * hidden + hidden * hidden + hidden)
        + nj * 2 * hidden * 4)
    dyn = dyn_ops(anc)
    warm = not exact and warm_iters > 0
    solve = solve_ops(jnz, P, nv, warm_iters if warm else num_iters,
                      warm, flat)
    integ = 100 + 4 * nv
    per_substep = torque + 10 * nj + 2 * dyn + 4 * nv + solve + integ
    if exact:
        ops = D * (cache_rebuild_ops(model) + cache + per_substep)
    else:
        ops = cache + D * per_substep
    if entry:
        ops += cache_rebuild_ops(model)
        if not flat:
            ops += P * HEIGHTFIELD_SAMPLE_OPS
    return 4 * (floats_in + floats_out), ops


def kernel_work(config: dict, num_envs: int, model=None):
    """(bytes, operations) of one control-step launch over `num_envs` envs
    in the configuration's mode (the cache built in the launch, warm
    solves), for the robot `model` (by default the Go1 of the plain
    reference the configuration names)."""
    if model is None:
        import importlib

        from . import spec
        model = importlib.import_module(
            spec.reference(config) + ".models.robot").go1()
    k = config["kernel"]
    b, ops = work_per_env(model, config["decimation"], k["warm_iters"],
                          hidden=k["actuator_hidden"],
                          features=k["actuator_features"],
                          control_type=k["control_type"], exact=k["exact"],
                          num_iters=k["num_iters"], flat=k["flat"],
                          entry=k["entry"])
    return b * num_envs, ops * num_envs


def least_seconds(nbytes: float, ops: float):
    """(least time on one card, which bound sets it: 'bytes' or 'operations')."""
    tb, to = nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- the MLPs of one PPO iteration -------------------------------------------------


def mlp_forward(sizes) -> int:
    """fp32 FLOPs of one sample through the products of an MLP (a
    multiply-add counts 2; biases and activations are not counted)."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def mlp_backward(sizes, input_grad: bool) -> int:
    """fp32 FLOPs of one sample back through an MLP: the weights' gradients
    of every layer, and the gradient of every layer's input but the first's
    unless `input_grad` (the first layer's input is data)."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    w = sum(2 * a * b for a, b in pairs)
    x = sum(2 * a * b for a, b in (pairs if input_grad else pairs[1:]))
    return w + x


def iteration_flops(config: dict, num_envs: int, num_steps: int) -> dict:
    """fp32 FLOPs of one PPO iteration over `num_envs` train envs and
    `num_steps` control steps, by part: the rollout's policy forwards, the
    update's forwards and backwards (`num_learning_epochs` x every sample)
    and the adaptation steps, and the control-step kernel's operations."""
    nets = config["networks"]
    ppo = config["ppo"]
    batch = num_envs * num_steps
    f = {k: mlp_forward(v) for k, v in nets.items()}
    epochs = ppo["num_learning_epochs"]
    if config["algo"] == "cse":
        # rollout: actor_mean = adaptation + actor; values = critic
        per_sample_act = f["adaptation"] + f["actor"] + f["critic"]
        rollout = batch * per_sample_act + num_envs * f["critic"]
        # update: adaptation + actor + critic forward; backward through the
        # critic (input is data), the actor (its input holds the latent),
        # the adaptation module (input is data); then the adaptation step:
        # forward and backward of the adaptation module
        upd = (f["adaptation"] + f["actor"] + f["critic"]
               + mlp_backward(nets["critic"], False)
               + mlp_backward(nets["actor"], True)
               + mlp_backward(nets["adaptation"], False)
               + f["adaptation"] + mlp_backward(nets["adaptation"], False))
    elif config["algo"] == "rma":
        # rollout: teacher = encoder + actor; values = encoder + critic
        per_sample_act = 2 * f["encoder"] + f["actor"] + f["critic"]
        rollout = batch * per_sample_act + num_envs * (f["encoder"]
                                                       + f["critic"])
        # update: encoder + actor, encoder + critic forward and backward
        # (the heads' inputs hold the latent; the encoder's input is data),
        # the distillation target (encoder forward) and the adaptation
        # module's forward and backward
        upd = (2 * f["encoder"] + f["actor"] + f["critic"]
               + mlp_backward(nets["actor"], True)
               + mlp_backward(nets["critic"], True)
               + 2 * mlp_backward(nets["encoder"], False)
               + f["encoder"] + f["adaptation"]
               + mlp_backward(nets["adaptation"], False))
    else:
        raise ValueError(f"unknown algo {config['algo']!r}")
    update = epochs * batch * upd
    _, kernel_ops = kernel_work(config, num_envs)
    kernel = num_steps * kernel_ops
    return dict(rollout=float(rollout), update=float(update),
                kernel=float(kernel),
                total=float(rollout + update + kernel))

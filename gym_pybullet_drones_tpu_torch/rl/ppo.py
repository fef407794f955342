"""PPO on the env batch: rollout, GAE and minibatched clipped-surrogate updates.

Port of the JAX package's ``rl/ppo.py``. The reference trains its RL tasks
with stable-baselines3 PPO (examples/learn.py:73-95: ``PPO('MlpPolicy', ...)``);
here the policy forward, the batched env step, GAE and the updates all run on
the env batch's device, time and minibatches as Python loops of tensor
operations. The network and hyperparameters mirror SB3's defaults so the
solved-reward thresholds compare (learn.py:79-82): separate pi/vf towers of
two tanh-64 layers, a Gaussian policy with a state-independent log-std, lr
3e-4, 10 epochs, gamma 0.99, GAE lambda 0.95, clip 0.2, vf coef 0.5, max
grad norm 0.5.

Every draw (init, policy noise, epoch permutations) comes from the runner's
``torch.Generator``; nothing touches the global RNG. A CUDA generator and a
CPU generator give different streams. Matrix products run in full float32:
leave ``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default),
and for the pixel policy's convolutions turn ``torch.backends.cudnn.allow_tf32``
off as well (PyTorch's default is on).

RGB configs train ``CnnActorCritic`` (SB3's CnnPolicy: NatureCNN features per
drone, then ActorCritic's heads) on the held camera frames, which the rollout
keeps as uint8.
"""

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.params import randomize_params
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import AviaryConfig, AviaryState
from gym_pybullet_drones_tpu_torch.envs.spec import ObservationType
from gym_pybullet_drones_tpu_torch.runtime.rollout import (
    batch_reset,
    episode_stats,
    make_batched_step,
)


def _dense(n_in, n_out, gain, generator, device):
    # skip_init: nn.Linear's own init would draw from the global RNG
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out, device=device)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain, generator=generator)
        layer.bias.zero_()
    return layer


# flax's truncated normal draws in [-2, 2] and divides its std by this, the
# std of a unit normal truncated there (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight, fan_in, generator):
    """flax's default kernel init: a normal truncated at two std, of
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class ActorCritic(nn.Module):
    """SB3-MlpPolicy-equivalent actor-critic: separate pi and vf towers of
    ``hidden`` tanh layers, a mean head, a state-independent ``log_std`` and a
    value head. Orthogonal init (gains sqrt(2), 0.01 for the mean, 1.0 for the
    value) with zero biases, from ``generator``.

    ``forward(obs)`` takes obs of shape (E, ...), flattened per env, and
    returns ``(mean (E, A), log_std (A,), value (E,))``.
    """

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 log_std_init: float = 0.0, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        dense = lambda i, o, gain: _dense(i, o, gain, generator, device)
        widths = [obs_dim, *hidden]
        self.pi = nn.ModuleList(dense(i, o, math.sqrt(2)) for i, o in zip(widths, hidden))
        self.mean = dense(widths[-1], action_dim, 0.01)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init), device=device))
        self.vf = nn.ModuleList(dense(i, o, math.sqrt(2)) for i, o in zip(widths, hidden))
        self.value = dense(widths[-1], 1, 1.0)

    def forward(self, obs):
        obs = obs.reshape(obs.shape[0], -1)
        x = obs
        for layer in self.pi:
            x = torch.tanh(layer(x))
        v = obs
        for layer in self.vf:
            v = torch.tanh(layer(v))
        return self.mean(x), self.log_std, self.value(v).squeeze(-1)


class CnnActorCritic(nn.Module):
    """SB3-CnnPolicy-equivalent actor-critic for RGB observations.

    ``forward(obs)`` takes (E, N, H, W, C) uint8 frames (C = 4 x frame_stack),
    scales them by 1/255 and passes each drone's frames through NatureCNN
    (32 8x8 stride 4, 64 4x4 stride 2, 64 3x3 stride 1, VALID, ReLU; 48 x 64
    comes out as 2 x 4 x 64 = 512, flattened in NHWC order as flax does),
    a 512-wide ReLU layer, then concatenates the drones' features into
    ``heads``, an ``ActorCritic``. Returns ``(mean (E, A), log_std (A,),
    value (E,))``. The convolutions and the 512 layer take flax's default
    init (lecun normal, zero biases), the heads ActorCritic's, all from
    ``generator``.
    """

    FEATURES = 512
    # (out channels, kernel, stride) of NatureCNN
    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
    FRAME = (48, 64)  # the onboard camera's frame (BaseRLAviary.py:34)

    def __init__(self, num_drones: int, in_channels: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64), log_std_init: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.convs = nn.ModuleList()
        c, (h, w) = in_channels, self.FRAME
        for out, k, stride in self.LAYERS:
            conv = nn.utils.skip_init(nn.Conv2d, c, out, k, stride, device=device)
            with torch.no_grad():
                _lecun_normal_(conv.weight, c * k * k, generator)
                conv.bias.zero_()
            self.convs.append(conv)
            c, h, w = out, (h - k) // stride + 1, (w - k) // stride + 1
        flat = c * h * w
        self.feat = nn.utils.skip_init(nn.Linear, flat, self.FEATURES, device=device)
        with torch.no_grad():
            _lecun_normal_(self.feat.weight, flat, generator)
            self.feat.bias.zero_()
        self.heads = ActorCritic(num_drones * self.FEATURES, action_dim, hidden, log_std_init,
                                 generator, device)

    @property
    def log_std(self):
        return self.heads.log_std

    def forward(self, obs):
        E, N = obs.shape[0], obs.shape[1]
        x = obs.to(torch.float32).reshape((E * N,) + obs.shape[2:]) / 255.0
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view: channels-last memory)
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(E * N, -1)  # flax flattens NHWC
        x = torch.relu(self.feat(x))
        return self.heads(x.reshape(E, -1))


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (the JAX package's ``PPOConfig``, field for field).

    SB3 defaults where the setting is per-update math. ``n_steps`` defaults to
    256 rather than SB3's 2048: the learner runs wide env batches, and the
    product ``num_envs * n_steps`` (samples per update) is what compares.
    """

    num_envs: int = 8
    n_steps: int = 256  # per-env rollout length between updates
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    n_epochs: int = 10
    # None keeps SB3's 32 minibatches an epoch (its 2048-sample batch in rows
    # of 64) at any batch width; an int pins the minibatch size.
    minibatch_size: Optional[int] = None
    hidden: tuple = (64, 64)
    log_std_init: float = 0.0  # SB3's default
    # Cap log_std from above along log_std_init -> log_std_anneal_to over
    # log_std_anneal_updates updates (None disables): shrinks the gap between
    # the stochastic training policy and the deterministic eval policy.
    log_std_anneal_to: Optional[float] = None
    log_std_anneal_updates: int = 1
    # KL-adaptive learning rate: after each update, approx_kl above 2x target
    # divides the LR by 1.5, below target/2 multiplies it by 1.5, clamped to
    # [lr/100, lr*100]. None keeps the LR fixed.
    target_kl: Optional[float] = None
    # The first round(det_frac * num_envs) envs roll out with the mean action
    # (no noise), so the mean policy's own returns enter the objective.
    det_frac: float = 0.0
    # With make_ppo_train_step(..., anchor=True): the loss adds
    # anchor_coef * E[(mu_theta(s) - mu_anchor(s))^2], a pull of the policy
    # mean toward a snapshot (no gradient through the snapshot).
    anchor_coef: float = 0.0

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.n_steps

    @property
    def resolved_minibatch_size(self) -> int:
        if self.minibatch_size is not None:
            return self.minibatch_size
        return max(1, self.batch_size // 32)  # SB3: 32 minibatches an epoch

    @property
    def num_minibatches(self) -> int:
        # SB3's partial trailing minibatch is not reproduced: a non-divisor
        # would silently leave samples unvisited each epoch.
        if self.batch_size % self.resolved_minibatch_size != 0:
            raise ValueError(
                f"minibatch_size {self.resolved_minibatch_size} must divide "
                f"batch_size {self.batch_size} (= num_envs * n_steps); SB3's "
                "partial trailing minibatch has no static-shape equivalent")
        return self.batch_size // self.resolved_minibatch_size


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PPORunnerState:
    """What a train step carries. ``params`` (the network) and ``opt_state``
    (its Adam) are updated in place by the train step; ``generator`` draws the
    policy noise and the epoch permutations."""

    params: nn.Module  # ActorCritic, or CnnActorCritic for RGB configs
    opt_state: torch.optim.Adam
    env_state: AviaryState
    obs: torch.Tensor
    generator: torch.Generator
    update_count: int

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


_LOG_2PI = math.log(2.0 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)


def _gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI), dim=-1)


def compute_gae(value, reward, done, last_value, gamma, gae_lambda):
    """GAE over (T, E) columns, in reverse. Step t bootstraps from V(s_{t+1})
    masked by its OWN done_t: after a done, s_{t+1} is the auto-reset obs of a
    new episode. Returns ``(advantages, returns)``."""
    adv = torch.empty_like(value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(value.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - done[t].to(value.dtype)
        delta = reward[t] + gamma * next_value * nonterminal - value[t]
        gae = delta + gamma * gae_lambda * nonterminal * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


def _generator(generator_or_seed, device) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator(device=device).manual_seed(int(generator_or_seed))


def ppo_init(env_cfg: AviaryConfig, ppo_cfg: PPOConfig, generator_or_seed,
             params_env=None, ctrl_params=None, target_pos=None, domain_rand=None,
             device=None):
    """The initial ``PPORunnerState`` and ``aux`` (the env's parameter records).

    ``generator_or_seed`` is a ``torch.Generator`` on ``device`` or an int
    seed for one. ``domain_rand`` is an optional ``randomize_params`` spec
    (e.g. ``{"m": 0.1, "kf": 0.05}``): each training env then steps its own
    perturbed plant (``aux["train_params_env"]``), while evaluation and the
    controller stay nominal. ``device=None`` means the CUDA card. RGB configs
    get a ``CnnActorCritic`` on (48, 64, 4 x frame_stack) frames.
    """
    device = resolve_device(device)
    params_env = envbase.build_params(env_cfg, device) if params_env is None else params_env
    if ctrl_params is None:
        ctrl_params = envbase.build_ctrl_params(env_cfg, device)
    if target_pos is None:
        target_pos = envbase.hover_target_pos(env_cfg, params_env)
    generator = _generator(generator_or_seed, device)
    act_dim = env_cfg.num_drones * env_cfg.action_dim
    if env_cfg.obs_type == ObservationType.RGB:
        network = CnnActorCritic(env_cfg.num_drones, 4 * env_cfg.frame_stack, act_dim,
                                 ppo_cfg.hidden, ppo_cfg.log_std_init, generator, device)
    else:
        network = ActorCritic(env_cfg.num_drones * env_cfg.obs_dim, act_dim, ppo_cfg.hidden,
                              ppo_cfg.log_std_init, generator, device)
    opt = torch.optim.Adam(network.parameters(), lr=ppo_cfg.learning_rate, eps=1e-5)
    env_state = batch_reset(env_cfg, params_env, ppo_cfg.num_envs, device=device)
    runner = PPORunnerState(
        params=network, opt_state=opt, env_state=env_state,
        obs=envbase.compute_obs(env_cfg, env_state), generator=generator, update_count=0)
    aux = dict(params_env=params_env, ctrl_params=ctrl_params, target_pos=target_pos)
    if domain_rand:
        aux["train_params_env"] = randomize_params(generator, params_env, ppo_cfg.num_envs,
                                                   domain_rand)
    return runner, aux


def clip_by_global_norm_(grads, max_norm):
    """optax.clip_by_global_norm in place: scale by max_norm / ||g|| only where
    ||g|| >= max_norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm and is another function)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
    for g in grads:
        g.mul_(scale)
    return g_norm


def _log_std_cap(ppo_cfg: PPOConfig, update_count: int):
    """The annealing cap after update ``update_count``, in float32 as JAX
    computes it."""
    f32 = np.float32
    frac = min(f32(1.0), f32(update_count + 1.0) / f32(max(1, ppo_cfg.log_std_anneal_updates)))
    delta = f32(ppo_cfg.log_std_anneal_to - ppo_cfg.log_std_init)
    return float(f32(f32(ppo_cfg.log_std_init) + f32(delta * frac)))


def rollout_step(net, step_env, env_state, obs, generator, n_det, layout, rows=None):
    """One control step of a PPO rollout: the policy's Gaussian sample (the
    first ``n_det`` envs take the mean), clipped to [-1, 1] and shaped
    (E, *layout), then ``step_env``. Returns ``(env_state, StepOutput,
    Transition)``; call it under ``torch.no_grad()``.

    ``rows=(first, total)``: these E envs are rows ``first`` to ``first + E``
    of a batch of ``total`` sharded over processes. The noise of all
    ``total`` rows is drawn, as one process would draw it, and these rows
    kept; ``n_det`` counts rows of the whole batch."""
    mean, log_std, value = net(obs)
    first, total = (0, mean.shape[0]) if rows is None else rows
    noise = torch.randn((total,) + tuple(mean.shape[1:]), generator=generator,
                        dtype=mean.dtype, device=mean.device)
    if n_det > 0:
        noise[:n_det] = 0.0
    noise = noise[first:first + mean.shape[0]]
    action = mean + torch.exp(log_std) * noise
    logp = _gaussian_log_prob(mean, log_std, action)
    env_state, out = step_env(env_state,
                              torch.clamp(action, -1.0, 1.0).reshape((-1,) + tuple(layout)))
    return env_state, out, Transition(obs, action, logp, value, out.reward,
                                      out.terminated | out.truncated)


def make_ppo_train_step(env_cfg: AviaryConfig, ppo_cfg: PPOConfig, aux, anchor: bool = False,
                        mesh=None):
    """Build ``train_step(runner, anchor_params=None) -> (runner, metrics)``:
    one rollout of ``n_steps`` over the env batch, then ``n_epochs`` x
    ``num_minibatches`` updates. The network and its Adam are updated in place.

    ``mesh`` (``runtime/mesh.make_mesh``): the env axis is split over the
    ranks. Each rank holds its slice of the runner's env state and
    observations (``runtime/mesh.shard_env_batch``; of per-env
    ``aux["train_params_env"]`` too) and the same network, Adam and
    generator. It rolls out its slice with the whole batch's noise rows, the
    rollout is all-gathered, and every rank runs the one-process update on
    the whole batch: the same epoch permutations, minibatches and Adam steps,
    so the ranks stay equal bit for bit.

    Given ``anchor_params`` (an ``ActorCritic``, e.g. the best
    deterministic-eval snapshot; ``anchor=True`` names that use, as in the JAX
    signature), the loss adds ``anchor_coef`` times the mean-policy pull
    toward it; no gradient flows into the snapshot.

    ``train_step.collect(runner)`` and ``train_step.update(runner, rollout,
    anchor_params=None)`` are its rollout and update halves.
    """
    step_env = make_batched_step(env_cfg, aux.get("train_params_env", aux["params_env"]),
                                 aux["ctrl_params"], aux["target_pos"], auto_reset=True)
    n_drones, act_per = env_cfg.num_drones, env_cfg.action_dim
    n_det = int(round(ppo_cfg.det_frac * ppo_cfg.num_envs))
    bsz, nmb = ppo_cfg.batch_size, ppo_cfg.num_minibatches
    if mesh is None:
        rows, gather = None, lambda x, dim: x
    else:
        from gym_pybullet_drones_tpu_torch.runtime.mesh import all_gather, env_sharding

        rows = (env_sharding(mesh).rows(ppo_cfg.num_envs).start, ppo_cfg.num_envs)
        gather = lambda x, dim: all_gather(mesh, x, dim)
    mbs = bsz // nmb
    clip = ppo_cfg.clip_range

    def loss_fn(net, mb, adv, ret, anchor_params):
        mean, log_std, value = net(mb.obs)
        logp = _gaussian_log_prob(mean, log_std, mb.action)
        ratio = torch.exp(logp - mb.log_prob)
        norm_adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = torch.maximum(-norm_adv * ratio,
                                -norm_adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).mean()
        v_loss = 0.5 * torch.mean((value - ret) ** 2)
        entropy = torch.sum(log_std + _HALF_LOG_2PIE)
        total = pg_loss + ppo_cfg.vf_coef * v_loss - ppo_cfg.ent_coef * entropy
        if anchor_params is not None:
            with torch.no_grad():
                a_mean = anchor_params(mb.obs)[0]
            total = total + ppo_cfg.anchor_coef * torch.mean((mean - a_mean) ** 2)
        with torch.no_grad():  # Schulman's estimator E[(r - 1) - log r]
            approx_kl = torch.mean((ratio - 1.0) - torch.log(ratio + 1e-12))
        return total, approx_kl

    def collect(runner: PPORunnerState):
        """The rollout half: ``n_steps`` control steps, the truncation
        bootstrap and GAE. Returns the runner past the rollout (same update
        count) and ``(batch, adv, ret, stats)``, flattened over (T * E)."""
        net, gen = runner.params, runner.generator
        env_state, obs = runner.env_state, runner.obs
        steps, finals, truncs = [], [], []
        with torch.no_grad():
            for _ in range(ppo_cfg.n_steps):
                env_state, out, tr = rollout_step(net, step_env, env_state, obs, gen, n_det,
                                                  (n_drones, act_per), rows)
                steps.append(tr)
                finals.append(out.final_obs)
                truncs.append(out.truncated & ~out.terminated)
                obs = out.obs
            # (T, E) columns of the whole batch (sharded: gathered over the envs)
            traj = Transition(*(gather(torch.stack(x), 1) for x in zip(*steps)))
            stats = dict(mean_reward=traj.reward.mean(),  # env reward, without the bootstrap
                         mean_value=traj.value.mean(), episodes_done=traj.done.sum())
            if n_det > 0:  # the mean policy's own training reward, per step
                stats["mean_reward_det"] = traj.reward[:, :n_det].mean()
            # SB3's TimeLimit bootstrap: on truncation (not termination) add
            # gamma * V of the true next obs, from one batched forward.
            final_obs = gather(torch.stack(finals), 1)
            fv = net(final_obs.reshape((-1,) + final_obs.shape[2:]))[2].reshape(
                final_obs.shape[:2])
            traj = traj._replace(reward=traj.reward + ppo_cfg.gamma * fv * gather(
                torch.stack(truncs), 1).to(fv.dtype))
            last_value = net(gather(obs, 0))[2]
            adv, ret = compute_gae(traj.value, traj.reward, traj.done, last_value,
                                   ppo_cfg.gamma, ppo_cfg.gae_lambda)
            flat = lambda x: x.reshape((-1,) + x.shape[2:])
            batch = Transition(*(flat(x) for x in traj))
        return runner.replace(env_state=env_state, obs=obs), (batch, flat(adv), flat(ret), stats)

    def update(runner: PPORunnerState, rollout, anchor_params=None):
        """The update half: ``n_epochs`` x ``num_minibatches`` clipped-surrogate
        steps on ``collect``'s rollout, then the LR rule and the log-std cap.
        Returns ``(runner, metrics)`` with the update count advanced."""
        net, opt, gen = runner.params, runner.opt_state, runner.generator
        batch, adv, ret, stats = rollout
        losses, kls = [], []
        for _ in range(ppo_cfg.n_epochs):
            perm = torch.randperm(bsz, generator=gen, device=adv.device)
            kls.clear()
            for i in range(nmb):
                idx = perm[i * mbs:(i + 1) * mbs]
                mb = Transition(*(x[idx] for x in batch))
                opt.zero_grad(set_to_none=True)
                loss, kl = loss_fn(net, mb, adv[idx], ret[idx], anchor_params)
                loss.backward()
                clip_by_global_norm_([p.grad for p in net.parameters()],
                                     ppo_cfg.max_grad_norm)
                opt.step()
                losses.append(loss.detach())
                kls.append(kl)
        approx_kl = torch.stack(kls).mean()  # the last epoch: the post-update divergence
        if ppo_cfg.target_kl is not None:
            group = opt.param_groups[0]
            kl = float(approx_kl)
            lr = np.float32(group["lr"])
            if kl > 2.0 * ppo_cfg.target_kl:
                lr = lr / np.float32(1.5)
            elif kl < 0.5 * ppo_cfg.target_kl:
                lr = lr * np.float32(1.5)
            group["lr"] = float(np.clip(lr, np.float32(ppo_cfg.learning_rate / 100.0),
                                        np.float32(ppo_cfg.learning_rate * 100.0)))
        if ppo_cfg.log_std_anneal_to is not None:
            with torch.no_grad():
                net.log_std.clamp_(max=_log_std_cap(ppo_cfg, runner.update_count))
        metrics = dict(loss=torch.stack(losses).mean(), approx_kl=approx_kl, **stats)
        return runner.replace(update_count=runner.update_count + 1), metrics

    def train_step(runner: PPORunnerState, anchor_params=None):
        runner, rollout = collect(runner)
        return update(runner, rollout, anchor_params)

    # the two halves, to time them apart
    train_step.collect, train_step.update = collect, update
    return train_step


def make_ppo_train_loop(env_cfg: AviaryConfig, ppo_cfg: PPOConfig, aux, updates_per_call: int):
    """``train_loop(runner) -> (runner, metrics)``: ``updates_per_call`` train
    steps, each metric stacked along a leading (updates_per_call,) axis."""
    train_step = make_ppo_train_step(env_cfg, ppo_cfg, aux)

    def train_loop(runner):
        history = []
        for _ in range(updates_per_call):
            runner, m = train_step(runner)
            history.append(m)
        return runner, {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return train_loop


def _episode_stats(rewards, dones):
    """Mean return over completed episodes (the running mean where none
    completed) and their count, on the device. rewards, dones: (T, E)."""
    running, total, count = episode_stats(rewards, dones)
    n = count.sum()
    mean_ret = torch.where(n > 0, total.sum() / torch.clamp(n, min=1), running.mean())
    return mean_ret, n


def evaluate_policy(env_cfg: AviaryConfig, aux, params: ActorCritic, num_steps: int,
                    num_envs: int = 1, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Roll the policy out for exactly ``num_steps`` control steps on
    ``num_envs`` nominal envs with auto-reset; returns (mean episode return,
    completed episodes), the analogue of SB3's ``evaluate_policy``
    (learn.py:149-152). The SB3 protocol is 10 consecutive episodes on one env:
    the action buffer persists across auto-resets, so the episodes differ."""
    params_env = aux["params_env"]
    device = params_env.m.device
    step_env = make_batched_step(env_cfg, params_env, aux["ctrl_params"], aux["target_pos"],
                                 auto_reset=True)
    if generator is None and not deterministic:
        generator = torch.Generator(device=device).manual_seed(0)
    env_state = batch_reset(env_cfg, params_env, num_envs, device=device)
    obs = envbase.compute_obs(env_cfg, env_state)
    rewards, dones = [], []
    with torch.no_grad():
        for _ in range(num_steps):
            mean, log_std, _ = params(obs)
            action = mean if deterministic else mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=generator, dtype=mean.dtype, device=device)
            env_action = torch.clamp(action, -1.0, 1.0).reshape(
                num_envs, env_cfg.num_drones, env_cfg.action_dim)
            env_state, out = step_env(env_state, env_action)
            obs = out.obs
            rewards.append(out.reward)
            dones.append(out.terminated | out.truncated)
        mean_ret, count = _episode_stats(torch.stack(rewards), torch.stack(dones))
    return float(mean_ret), int(count)


def deterministic_rollout(env_cfg: AviaryConfig, aux, params: ActorCritic, num_steps: int):
    """Deterministic single-env rollout: the stacked 20-dim state vectors
    (T, N, 20) and the rewards (T,) (the logged replay of learn.py:155-192 /
    play.py:20-76)."""
    params_env, ctrl_params = aux["params_env"], aux["ctrl_params"]
    n, a = env_cfg.num_drones, env_cfg.action_dim
    state = envbase.reset(env_cfg, params_env)
    obs = envbase.compute_obs(env_cfg, state)
    states, rewards = [], []
    with torch.no_grad():
        for _ in range(num_steps):
            mean = params(obs[None])[0]
            state, obs, r, _, _ = envbase.step(env_cfg, params_env, ctrl_params,
                                               aux["target_pos"], state,
                                               torch.clamp(mean, -1.0, 1.0).reshape(n, a))
            states.append(envbase.drone_state_vector(env_cfg, state))
            rewards.append(r)
    return torch.stack(states), torch.stack(rewards)

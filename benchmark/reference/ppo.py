"""PPO's collect and update on the batched Hover env, in plain PyTorch.

A frozen copy of the algorithm the port's ``rl/ppo.make_ppo_train_step``
runs, SB3's PPO: a Gaussian policy of two tanh towers (pi and vf) with a
state-independent log-std; a rollout of ``n_steps`` control steps whose
noise is drawn, a (E, A) normal a step, from the run's generator; the
TimeLimit bootstrap of truncated steps; GAE; then ``n_epochs`` passes over a
permutation of the batch (one ``randperm`` an epoch from the same
generator) in minibatches of the clipped surrogate plus half the value
loss, each gradient clipped to a global norm before an Adam step; then the
cap of the annealed log-std. The network is a dict of leaf tensors in the
order the port's module lists its parameters.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)
PARAM_ORDER = ("log_std", "pi.0.weight", "pi.0.bias", "pi.1.weight", "pi.1.bias",
               "mean.weight", "mean.bias", "vf.0.weight", "vf.0.bias", "vf.1.weight",
               "vf.1.bias", "value.weight", "value.bias")


def forward(net, obs):
    """``(mean (E, A), log_std (A,), value (E,))`` of the actor-critic."""
    obs = obs.reshape(obs.shape[0], -1)
    x = torch.tanh(F.linear(obs, net["pi.0.weight"], net["pi.0.bias"]))
    x = torch.tanh(F.linear(x, net["pi.1.weight"], net["pi.1.bias"]))
    v = torch.tanh(F.linear(obs, net["vf.0.weight"], net["vf.0.bias"]))
    v = torch.tanh(F.linear(v, net["vf.1.weight"], net["vf.1.bias"]))
    mean = F.linear(x, net["mean.weight"], net["mean.bias"])
    value = F.linear(v, net["value.weight"], net["value.bias"]).squeeze(-1)
    return mean, net["log_std"], value


def log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + LOG_2PI), dim=-1)


def gae(value, reward, done, last_value, gamma, lam):
    adv = torch.empty_like(value)
    g = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(value.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - done[t].to(value.dtype)
        delta = reward[t] + gamma * next_value * nonterminal - value[t]
        g = delta + gamma * lam * nonterminal * g
        adv[t] = g
        next_value = value[t]
    return adv, adv + value


def log_std_cap(ppo: dict, update_count: int) -> float:
    """The annealed log-std's cap after update ``update_count``, in float32."""
    f32 = np.float32
    frac = min(f32(1.0), f32(update_count + 1.0) / f32(max(1, ppo["log_std_anneal_updates"])))
    delta = f32(ppo["log_std_anneal_to"] - ppo["log_std_init"])
    return float(f32(f32(ppo["log_std_init"]) + f32(delta * frac)))


class PPO:
    """The train step of ``ppo`` (a configuration's ``ppo`` group) on the env
    ``env`` (``reference/hover.Hover``), from the weights ``net`` (a dict of
    ``PARAM_ORDER`` tensors) and the generator ``gen``."""

    def __init__(self, env, ppo: dict, net: dict, gen: torch.Generator, num_envs: int):
        self.env, self.ppo, self.gen, self.E = env, ppo, gen, num_envs
        self.net = {k: net[k].detach().clone().requires_grad_(True) for k in PARAM_ORDER}
        self.params = [self.net[k] for k in PARAM_ORDER]
        self.opt = torch.optim.Adam(self.params, lr=ppo["learning_rate"], eps=1e-5)
        self.state = env.reset(num_envs)
        self.obs = env.obs(self.state)
        self.update_count = 0
        self.grads = []  # the gradients of the first optimizer step, as Adam gets them

    def collect(self):
        p, env, E = self.ppo, self.env, self.E
        s, obs = self.state, self.obs
        cols, finals, truncs = [], [], []
        with torch.no_grad():
            for _ in range(p["n_steps"]):
                mean, log_std, value = forward(self.net, obs)
                noise = torch.randn((E,) + tuple(mean.shape[1:]), generator=self.gen,
                                    dtype=mean.dtype, device=mean.device)
                action = mean + torch.exp(log_std) * noise
                logp = log_prob(mean, log_std, action)
                s, (nobs, reward, term, trunc, final) = env.batched_step(
                    s, torch.clamp(action, -1.0, 1.0).reshape((-1, env.N, env.A)))
                cols.append((obs, action, logp, value, reward, term | trunc))
                finals.append(final)
                truncs.append(trunc & ~term)
                obs = nobs
            obs_t, act_t, logp_t, val_t, rew_t, done_t = (torch.stack(x) for x in zip(*cols))
            final_obs = torch.stack(finals)
            fv = forward(self.net, final_obs.reshape((-1,) + final_obs.shape[2:]))[2].reshape(
                final_obs.shape[:2])
            rew_t = rew_t + p["gamma"] * fv * torch.stack(truncs).to(fv.dtype)
            last_value = forward(self.net, obs)[2]
            adv, ret = gae(val_t, rew_t, done_t, last_value, p["gamma"], p["gae_lambda"])
            flat = lambda x: x.reshape((-1,) + x.shape[2:])
            batch = tuple(flat(x) for x in (obs_t, act_t, logp_t, val_t, rew_t, done_t))
        self.state, self.obs = s, obs
        return batch, flat(adv), flat(ret)

    def update(self, rollout):
        p = self.ppo
        (b_obs, b_act, b_logp, _, _, _), adv, ret = rollout
        bsz = b_obs.shape[0]
        mbs = p["minibatch_size"]
        clip = p["clip_range"]
        losses = []
        for _ in range(p["n_epochs"]):
            perm = torch.randperm(bsz, generator=self.gen, device=adv.device)
            for i in range(bsz // mbs):
                idx = perm[i * mbs:(i + 1) * mbs]
                for t in self.params:
                    t.grad = None
                mean, log_std, value = forward(self.net, b_obs[idx])
                logp = log_prob(mean, log_std, b_act[idx])
                ratio = torch.exp(logp - b_logp[idx])
                a = adv[idx]
                norm_adv = (a - a.mean()) / (a.std(correction=0) + 1e-8)
                pg = torch.maximum(-norm_adv * ratio,
                                   -norm_adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).mean()
                v_loss = 0.5 * torch.mean((value - ret[idx]) ** 2)
                entropy = torch.sum(log_std + HALF_LOG_2PIE)
                loss = pg + p["vf_coef"] * v_loss - p["ent_coef"] * entropy
                loss.backward()
                grads = [t.grad for t in self.params]
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.where(g_norm < p["max_grad_norm"], torch.ones_like(g_norm),
                                    p["max_grad_norm"] / g_norm)
                for g in grads:
                    g.mul_(scale)
                if not self.grads:
                    self.grads = [g.detach().clone() for g in grads]
                self.opt.step()
                losses.append(loss.detach())
        with torch.no_grad():
            self.net["log_std"].clamp_(max=log_std_cap(p, self.update_count))
        self.update_count += 1
        return torch.stack(losses).mean()

    def train_step(self):
        """One collect and one update; returns the update's mean loss."""
        return self.update(self.collect())

"""k1_roofline: kernel K1's (``csrc/velocity_rollout.cu``) share of its
roofline, in %: the least time the card could take for one call, the larger
of the operations it needs (counted on the frozen reference) over 67 TFLOP/s
and its bytes (30 columns read, 26 written, float32) over 3.35 TB/s, against
K1's mean device time in the trace."""

from benchmark import opcount, peaks

KERNEL = "velocity_rollout"


def read(run):
    durs = [b - a for part in run.parts for name, a, b in part["ops"] if KERNEL in name]
    if not durs:
        return None
    E = int(run.config["env"]["num_envs"])
    T = int(run.traffic["control_steps_per_call"])
    ops = opcount.velocity_ops(run.config)
    flops = E * (ops["target"] + T * ops["control_step"])
    nbytes = E * (30 + 26) * 4
    bound = max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / (sum(durs) / len(durs))

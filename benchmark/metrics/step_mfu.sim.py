"""step_mfu.sim: the share of the card's float32 peak that the window's
drone-steps would need, in %: the operations one drone-step needs, counted
on the frozen reference (``opcount.velocity_ops``), times the drone-steps
completed, over window seconds x 67 TFLOP/s."""

from benchmark import opcount, peaks


def read(run):
    if "drone_steps" not in run.work or not run.window_s:
        return None
    ops = opcount.velocity_ops(run.config)
    per_call_steps = run.traffic.get("control_steps_per_call")
    per_step = ops["control_step"] + (ops["target"] / per_call_steps if per_call_steps
                                      else ops["target"])
    return 100.0 * per_step * run.work["drone_steps"] / (run.window_s * peaks.FP32_FLOPS)

"""``diffusion_ms_per_step.single``: the diffusion stage's stage-synced
wall after its weight cast (``timings["diffusion_loop_s"]``: the
conditioner and the denoising loop) over its steps, summed over the
window's utterances, in ms a step."""

from benchmark import readers


def read(run):
    return readers.stage_ms_per_step(
        (r.result.timings for r in run.done), "diffusion_loop_s",
        "diffusion_steps")

"""``ar_ms_per_step.single``: the AR sampling loop's stage-synced wall
(``SynthesisResult.timings["ar_decode_loop_s"]``) over its steps,
summed over the window's utterances, in ms a step."""

from benchmark import readers


def read(run):
    return readers.stage_ms_per_step(
        (r.result.timings for r in run.done), "ar_decode_loop_s",
        "ar_decode_steps")

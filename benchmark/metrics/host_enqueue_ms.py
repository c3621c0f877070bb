"""``host_enqueue_ms.train``: host ms per step inside the span ``train.step``
(the whole of ``DenoiseTrainStep.step``): the time the host takes to enqueue
a step. As it nears the step's interval the host sets the pace.

``host_enqueue_ms.sample``: host ms per denoise step inside the spans
``sample.model`` and ``sample.scheduler``: the host's time to enqueue one
model call and one scheduler step.

Both include launches blocked on a full launch queue: where the card sets
the pace they track the card's time, not the launch cost."""

from benchmark.metrics import program_spans


def read(r):
    if r.train:
        return program_spans.ms_per_unit(r, ("train.step",), host=True)
    return program_spans.ms_per_unit(r, ("sample.model", "sample.scheduler"), host=True,
                                     per_step=True)

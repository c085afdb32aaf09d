"""optimizer_ms.train: device milliseconds of one optimizer update
(``train.optim.adamw_update``, the ``bench.optimizer`` span), averaged
over the profiled steps."""

SPAN = "bench.optimizer"


def read(run):
    t = run.trace
    if t is None or not t.calls.get(SPAN) or t.device_s(SPAN) <= 0:
        return None
    return 1e3 * t.device_s(SPAN) / len(t.calls[SPAN])

"""serve_service_ms: the median milliseconds of one `predict` call in the
window, by the benchmark's clock around it."""

from portbench.readers import median_ms


def read(run):
    return median_ms(run.observed["service_s"])

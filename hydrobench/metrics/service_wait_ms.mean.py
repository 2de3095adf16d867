"""service_wait_ms.mean: the mean of the service's own queue time
(``QueryReport.queue_time_s``, submit to dispatch) over the window's
answered queries, in ms. All clients use one predicate name, so the
service runs their queries one at a time: this is that wait."""


def read(run):
    waits = [q["queue_s"] for q in run.queries if q["queue_s"] is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None

"""Host milliseconds a decode step takes to enqueue (the host's clock
around each ``serve_step`` call, with no sync), the mean over the untraced
window's steps.  Where the device is slower, the launch queue fills and a call
waits for it: the reading then tends to the step's device time."""


def read(run):
    d = [s for b in run.batches for s in b.dispatch_s]
    return 1e3 * sum(d) / len(d) if d else None

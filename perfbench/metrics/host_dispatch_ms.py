"""Entry: host ms from calling the step until it returns, before the loss
read, averaged over the measured window's steps (the benchmark's own
span, untraced)."""


def read(rec):
    d = rec['window']['dispatch_s']
    return 1e3 * sum(d) / len(d) if d else None

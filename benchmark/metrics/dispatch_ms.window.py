"""Host ms from the call of generate_sample to its return, before the poses are read (the benchmark's span), a request on average."""

from benchmark.common.readers import dispatch_ms


def read(rec):
    return dispatch_ms(rec)

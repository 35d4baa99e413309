"""The 95th percentile of the clients' time from send to answer, over
every request sent in the window (one not answered, or answered with an
error, counting as never answered), on the clients' own clock, in ms."""


def read(record):
    return record.get("e2e_p95_ms")

"""Seconds from the process's start to the first timed call: imports, the
kernel library's build or load, the inputs, the port's set-up and the
warm-up."""


def read(rec):
    return rec.setup_s

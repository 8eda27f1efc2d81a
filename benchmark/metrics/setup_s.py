"""Process start to the first timed solve (host clock): imports, kernel
load (a build on a checkout's first run), the operator's build, the two
warm-up solves."""


def read(rec):
    return rec["setup"]["total_s"]

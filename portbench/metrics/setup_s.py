"""Process start to the first timed submission: data build, the store,
kernel load (and, on a checkout's first run, the kernels' build), warm-up."""


def read(w):
    return w.setup_s

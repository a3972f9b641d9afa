"""setup_s: from the start of the process to the window's open:
imports, the card's start, the stream made on the card, the pipeline,
the warm-up frames and their graph captures (and, in a checkout's first
run, the kernels' build)."""


def read(rec):
    return rec.setup_s

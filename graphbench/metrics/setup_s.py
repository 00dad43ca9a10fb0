"""setup_s (end to end, host clock): from the process's start (the first line of
``run.py``) to the window's start: imports, the device's start, the
program's kernels built or loaded, the graph made and handed over, warm-up."""


def read(run):
    return run.setup_s

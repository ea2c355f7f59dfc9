"""Process start to the first timed call: imports, the kernel library,
weights, inputs and warm-up (host clock)."""

def read(run):
    return run["setup_s"]

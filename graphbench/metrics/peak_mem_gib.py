"""peak_mem_gib (end to end, the device's allocator): ``torch.cuda.max_memory_allocated``
over the window, from a reset at its start, so all that set-up left on the
card counts (the benchmark's generation scratch is freed before), less the
benchmark's own slots for the sampled results, which stay on the card at a
fixed size all through the window.  It sets the largest graph that fits.
None off the device."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return (run.memory_peak_bytes - run.sample_bytes) / 2**30

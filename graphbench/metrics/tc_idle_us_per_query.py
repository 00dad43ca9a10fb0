"""tc_idle_us_per_query (algorithms, device trace): the device's idle time
inside the program's ``spla.tc`` spans (``core/spans.py``'s clipping to the
window), a query: what ``algorithms.tc``'s host work costs around kernel 4.
None where the trace holds no such span (a program without them)."""

from graphbench.core import spans as S

SPANS = ("spla.tc",)


def read(run):
    t = run.trace
    if t is None or not t.device_ops or run.queries == 0 or not any(s[0] in SPANS for s in S.spans(t)):
        return None
    return S.idle_within(t, SPANS) / run.queries * 1e6

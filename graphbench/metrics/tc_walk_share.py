"""tc_walk_share (kernels, program counter): the share of the full walk's B
elements that the walk ``algorithms.tc`` chose read over the window, in %:
100 x ``algorithms.STATS["tc_walked"]`` / ``["tc_products"]``.  The full
walk reads 100%; kernel 4's ordered walk, which ``tc`` takes on a symmetric
0/1 pattern on the card, reads the entries (i, j) with j < i over row j's
columns below j, about a sixth on a uniform graph.  None where the program
has no such counter or counted none."""


def read(run):
    stats = run.counters["stats"]
    products, walked = stats.get("tc_products"), stats.get("tc_walked")
    if not products or walked is None:
        return None
    return 100.0 * walked / products

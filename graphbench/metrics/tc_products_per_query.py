"""tc_products_per_query (kernels, program counter): the elements of B's rows
that ``algorithms.tc`` walked over the window (``algorithms.STATS
["tc_products"]``: B's row length summed over every stored mask entry, which
is Σ deg² where mask = A = B), a query.  None where the program has no such
counter or counted none."""


def read(run):
    products = run.counters["stats"].get("tc_products")
    if not products or run.queries == 0:
        return None
    return products / run.queries

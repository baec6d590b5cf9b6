"""hot_hit_pct.<suffix>: the tiered store's memory-tier hits over its hits
and misses in the window (StoreStats), in %."""


def read(run):
    hits = run.delta("store", "tier_hits")
    total = hits + run.delta("store", "tier_misses")
    return 100.0 * hits / total if total else None

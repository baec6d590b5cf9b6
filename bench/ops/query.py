"""A light client's state query: ``prove_state_flat`` of an account drawn by
``key_dist`` at the head, then ``verify_state_flat``.  Every
``block_every``-th query first commits one block of ``block_writes`` writes
and renews the client's anchor, outside the query's latency.  One unit: one
query; its latency is prove plus verify."""


def run(fam, spans):
    every = int(fam.mix["block_every"])
    if len(fam.queries) % every == every - 1:
        w = int(fam.mix["block_writes"])
        keys = fam.draw(w).tolist()
        with spans.span("block"):
            fam.block(list(zip(keys, fam.values(w))), spans)
            fam.refresh()
    return 1.0, fam.query(int(fam.draw(1)[0]), spans)

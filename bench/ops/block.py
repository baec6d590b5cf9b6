"""A ledger block: ``reads`` reads and ``writes`` writes in a seeded order, to
accounts drawn by ``key_dist`` (``zipfian``: YCSB's scrambled zipfian, theta
0.99; or ``uniform``), then ``commit()``.  Units: the block's reads and
writes (its transactions)."""
import numpy as np


def run(fam, spans):
    r, w = int(fam.mix["reads"]), int(fam.mix["writes"])
    keys = fam.draw(r + w).tolist()
    kinds = np.zeros(r + w, dtype=bool)
    kinds[:w] = True
    fam.rng.shuffle(kinds)
    vals = iter(fam.values(w))
    fam.block([(k, next(vals) if is_write else None)
               for k, is_write in zip(keys, kinds.tolist())], spans)
    return float(r + w), None

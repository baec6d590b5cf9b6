"""An analytics checkout: one whole version, drawn uniformly among those the
set-up committed, read back through the verifying store.  Units: bytes."""


def run(fam, spans):
    v = fam.choices[int(fam.rng.integers(len(fam.choices)))]
    return float(fam.read(v, spans)), None

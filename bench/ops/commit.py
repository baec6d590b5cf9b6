"""An analytics commit: ``edit_records`` records rewritten (``edit_pattern``
``scattered`` or ``contiguous``), put and ``sync()``; every
``fork_every``-th commit first forks a branch off master and commits there.
One unit: one commit."""


def run(fam, spans):
    every = int(fam.mix.get("fork_every", 0))
    fork = bool(every) and fam.commits % every == every - 1
    fam.commit(int(fam.mix["edit_records"]), fam.mix["edit_pattern"], fork,
               spans)
    return 1.0, None

"""launches_per_op.<suffix>: kernel launches (repro_torch.kernels.ops's
counter, every kernel) in the window over the operations completed."""


def read(run):
    if not run.window.completed:
        return None
    total = sum(run.delta("launches", k) for k in run.after["launches"])
    return total / run.window.completed

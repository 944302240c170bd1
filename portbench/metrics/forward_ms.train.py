"""Device kernel milliseconds a step inside the profiled split steps'
``forward`` part (between its marks, ending in a sync)."""


def read(run):
    t = run["trace"]
    if t is None or run["kind"] != "train_step":
        return None
    return t["parts"]["kernel_ms_by_part"].get("forward")

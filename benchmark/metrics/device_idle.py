"""device_idle: the share of the traced window in which no kernel, copy or
set ran on the card (torch.profiler), in %. ``device_idle.<cells>`` is this
quantity in the cells that metric lists."""


def read(run: dict):
    tr = run.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

"""1 - the union of device activity over the traced stretch, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

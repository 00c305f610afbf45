"""Share of the traced segment in which no operation ran on the device."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100

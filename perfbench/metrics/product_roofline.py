"""The whole product's share of its roofline: its least time times the
window's products, over the wall seconds of the window's calls."""


def read(ctx):
    if not ctx["products"] or ctx["window_s"] <= 0:
        return None
    return ctx["least_time_s"] * ctx["products"] / ctx["window_s"] * 100

"""The device work's share of a product's roofline: the product's least
time over the device's busy time a product, in the traced segment (the
union of the intervals of every kernel, copy and memset)."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["busy_s"] <= 0 or not prof["products"]:
        return None
    return ctx["least_time_s"] * prof["products"] / prof["busy_s"] * 100

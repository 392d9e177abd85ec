"""The host's kernel launch calls per rendered view in the traced stretch."""


def read(ctx):
    if not ctx["units"] or not ctx["summary"]["busy_s"]:
        return None
    return ctx["summary"]["launches"] / ctx["units"]

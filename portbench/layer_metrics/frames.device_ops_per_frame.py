"""Device operations (kernels, copies, fills) a traced frame: the dispatch
and glue a frame costs."""


def read(ctx, run):
    tr = run.get("trace") or {}
    if not tr.get("spans") or not tr.get("ops"):
        return None
    return tr["ops"] / tr["spans"]

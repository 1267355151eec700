"""Share of the window's target-frames whose inlier check failed (%), so
that the local fallback's second flow ran."""


def read(run):
    if not run.records:
        return None
    return 100.0 * sum(not r["ok"] for r in run.records) / len(run.records)

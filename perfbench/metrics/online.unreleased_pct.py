"""online.unreleased_pct: the share of the event loop's row reads spent on
rows not yet released: 100 x the sum of `unreleased` over the sum of
`visited`, over the window's `fast/event_loop` spans. Nothing where the
program does not count `unreleased`."""


def read(obs):
    spans = [r for r in obs.get("spans") or []
             if r["name"] == "fast/event_loop"
             and isinstance(r.get("attrs", {}).get("unreleased"), int)]
    visited = sum(r["attrs"].get("visited", 0) for r in spans)
    if not spans or visited <= 0:
        return None
    return 100.0 * sum(r["attrs"]["unreleased"] for r in spans) / visited

"""The engine's own mean decode step over the window, in milliseconds:
``Engine.stats["decode_s"] / stats["decode_steps"]`` (each step timed to
where its sampled ids reach the host)."""


def read(run):
    stats = run.result.stats
    if not stats.get("decode_steps"):
        return None
    return 1e3 * stats["decode_s"] / stats["decode_steps"]

"""Host syncs per solve inside the L-BFGS runs: the program's reads and
copies that wait for the card (``utils.tracing.sync``), summed over the
stages (``eval_stats[*]["host_syncs"]``)."""


def read(record):
    solves = record["solves"]
    counts = [v["host_syncs"] for s in solves for v in s["eval_stats"].values()
              if "host_syncs" in v]
    if not solves or not counts:
        return None
    return sum(counts) / len(solves)

"""Mean unique live pages of a dispatched search batch
(``lire.scan_page_stats`` on every batch the window dispatched, called
after the window on the same state)."""


def read(ctx):
    b = ctx.get("batches")
    return sum(x["n_unique"] for x in b) / len(b) if b else None

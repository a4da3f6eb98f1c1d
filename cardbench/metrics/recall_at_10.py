"""Mean recall@10 of the seeded sample of window searches against the
plain reference's exact top-10 of the live set at each search's seqno."""


def read(ctx):
    return ctx["numbers"].get("recall")

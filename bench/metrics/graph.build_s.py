"""graph build: seconds of the port's host ``build_graph`` (``graphs/ingest.py``,
``graphs/layout.py``) on the cell's edge list, by the harness's clock."""


def read(ctx):
    return ctx.setup["build_s"]

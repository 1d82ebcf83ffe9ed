"""The port's benchmark suites: one module per table or figure of the
paper and per framework extra, each a thin adapter over the public
``repro_torch`` API, run by ``repro_torch.benches.run`` and
``Runtime.bench``.  Every suite runs on its Runtime's device (the card by
default) and writes only under its output directory (``results/torch/``
by default)."""

"""Developer tools of the port (the JAX package's sphexa_tpu/devtools):
the audit (``devtools/audit``: the entry registry, its static roofline
cost layer, the trace rules, the locks and the audit on ranks) and the
lint (``devtools/lint``: torchlint, the AST rules JXL001, JXL002, JXL003
and JXL006, ``python -m sphexa_torch.devtools.lint``)."""

"""Per-layer metric readers, one module each: ``read(ctx, spec)`` returns
the metric's value, or None when the traced stretch holds nothing to read.
A metric file ``metrics/<name>.json`` names its reader."""

"""Device ms a frame inside the port's environment range (the escaped
rays' radiance from the environment lights), where the configuration's
adapter names it."""
from portbench import tracing


def read(ctx):
    return tracing.span_ms(ctx, 'env') if 'env' in ctx['spans'] else None

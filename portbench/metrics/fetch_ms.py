"""Device ms a frame inside the port's texture fetch range."""
from portbench import tracing


def read(ctx):
    return tracing.span_ms(ctx, 'fetch')

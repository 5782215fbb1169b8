"""Device ms a frame inside the port's light-sampling range."""
from portbench import tracing


def read(ctx):
    return tracing.span_ms(ctx, 'lights')

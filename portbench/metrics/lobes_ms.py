"""Device ms a frame inside the port's lobe range (the lobes' eval in
the light samples and their sampling in the scatter), where the
configuration's adapter names it."""
from portbench import tracing


def read(ctx):
    return tracing.span_ms(ctx, 'lobes') if 'lobes' in ctx['spans'] else None

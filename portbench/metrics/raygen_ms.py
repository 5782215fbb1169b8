"""Device ms a frame inside the port's camera-ray range (each pass's
film points and camera rays), where the configuration's adapter names
it."""
from portbench import tracing


def read(ctx):
    return (tracing.span_ms(ctx, 'raygen') if 'raygen' in ctx['spans']
            else None)

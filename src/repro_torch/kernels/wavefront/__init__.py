from .ops import wavefront_expand, wavefront_ref

"""K1's block-streaming route with 16-byte copies (``csrc/stencil_site.cu``,
the clover term's (1, 1, 12, 12)) as a share of its roofline, as
``k1_roofline.tiled`` reads its own.  Read only where the port's launch
counter shows the ``site16`` form ran and no other form of that file."""

from _device import roofline


def read(t: dict):
    if t.get("launches", {}).get("k1.site"):
        return None
    return roofline(t, "k1.site16")

"""The least time of one apply of the general operator (the port's
csrc/general_apply.cu: an element kernel and a node pass) from the mesh,
not from the kernels' design: the connectivity (4 bytes an index), the
coordinates, u and the result once (3 values a node each), the free mask
as the 3 bits a node that say which directions are fixed, and one 6 x 6
D, moved at the HBM rate, against one element stiffness product
2 (3 nn)^2 flops an element at the peak rate of the type. A kernel that
reads less than the stored geometry stays under it."""

from __future__ import annotations

from perfbench import peaks

# The two kernels' names in a device trace, in float32.
ELEMENT_KERNEL = "general_element_kernel<float"
NODE_KERNEL = "general_node_kernel<float"


def counts(nelem: int, nnode: int, nn: int, size: int) -> tuple:
    """(bytes, floating-point operations) of one apply on a mesh of nelem
    elements of nn nodes and nnode nodes, `size` bytes a value."""
    nbytes = 4 * nelem * nn + 9 * nnode * size + -(-3 * nnode // 8) + 36 * size
    return nbytes, 2 * (3 * nn) ** 2 * nelem


def bound_s(nelem: int, nnode: int, nn: int, size: int) -> float:
    nbytes, flops = counts(nelem, nnode, nn, size)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS[size])

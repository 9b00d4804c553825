"""hpl.panel_ms: device time of the panel kernels per solve, in ms.

The kernels of ``kernels/csrc/lu.cu``: the diagonal block's factorization
(``lu_warp_kernel``, ``lu_cta_kernel``) and the two triangular solves
(``trsm_lower_kernel``, ``trsm_upper_kernel``).
"""

KERNELS = ("lu_warp_kernel", "lu_cta_kernel", "trsm_lower_kernel",
           "trsm_upper_kernel")


def read(ctx):
    spent = ctx.trace.seconds(*KERNELS)
    if not ctx.units or spent <= 0:
        return None
    return 1e3 * spent / ctx.units

"""Pallas-Triton block-sparse kernels and their plain twins.

``bsr_spmm.py`` / ``bsr_spmm_t.py`` / ``bsr_sddmm.py`` hold the block-CSR
family, ``flash_sparse.py`` the block-sparse flash attention,
``bsr_compressed.py`` the true-BSR layout ops; ``dispatch.py`` is the flat
surface consumed by ``ops.api``.
"""

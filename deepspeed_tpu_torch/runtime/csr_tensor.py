"""CSR (compressed sparse row) gradient representation.

Port of ``deepspeed_tpu/runtime/csr_tensor.py`` (the reference's
``deepspeed/runtime/csr_tensor.py`` API) on tensors: a row-sparse matrix
keeps the rows with any nonzero entry and their indices.
:func:`all_gather_concat` sums per-rank CSR shards into the dense
gradient, the result of the reference's ``sparse_allreduce_bucket``
(all-gather of values and indices, then a scatter-add).
"""
import numpy as np
import torch


class CSRTensor:
    """Row-sparse matrix: only rows with any nonzero are stored."""

    def __init__(self, indices, values, dense_size):
        self.indices = torch.as_tensor(indices, dtype=torch.int32)
        self.values = torch.as_tensor(values)
        self.dense_size = tuple(dense_size)

    @staticmethod
    def from_dense(dense):
        """Keep rows with any nonzero entry (reference ``from_dense``)."""
        dense = torch.as_tensor(dense)
        nnz = dense.abs().reshape(dense.shape[0], -1).sum(dim=1) != 0
        indices = torch.nonzero(nnz).reshape(-1).to(torch.int32)
        return CSRTensor(indices, dense[indices.long()], dense.shape)

    def to_dense(self):
        dense = torch.zeros(self.dense_size, dtype=self.values.dtype,
                            device=self.values.device)
        if self.indices.numel():
            dense[self.indices.long()] = self.values
        return dense

    def sparse_size(self):
        """(stored elements, total elements): the reference's logging
        ratio's ingredients."""
        return int(self.values.numel()), int(np.prod(self.dense_size))

    def add(self, other):
        """Elementwise add of two CSR tensors over the same dense shape."""
        assert self.dense_size == other.dense_size
        return CSRTensor.from_dense(self.to_dense() + other.to_dense())

    def __repr__(self):
        stored, total = self.sparse_size()
        return "CSRTensor(dense_size={}, stored={}/{})".format(
            self.dense_size, stored, total)


def all_gather_concat(csr_list):
    """Per-rank CSR shards -> their summed dense gradient (the reference's
    gather-then-scatter-add; duplicate rows add)."""
    assert csr_list
    dense = csr_list[0].to_dense()
    for csr in csr_list[1:]:
        if csr.indices.numel():
            dense.index_add_(0, csr.indices.long(),
                             csr.values.to(dense.dtype))
    return dense

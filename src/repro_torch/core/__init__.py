"""Formats, contractions, projections, LSH families, segments, the
indexes and the paper's closed forms (``theory``), in PyTorch (reference:
``repro.core``)."""

from repro_torch.core import theory
from repro_torch.core.index import (DeviceLSHIndex, HostLSHIndex,
                                    ShardedLSHIndex, brute_force,
                                    brute_force_batch, recall_at_k)
from repro_torch.core.lsh import (LSHFamily, make_family, make_mults,
                                  naive_storage_size)
from repro_torch.core.projections import project, project_batch
from repro_torch.core.tensor_formats import (CPTensor, DenseTensor, TTTensor,
                                             as_batch, cp_gaussian,
                                             cp_rademacher,
                                             cp_als, cp_random_data,
                                             cp_to_dense, dense_to_tt,
                                             khatri_rao, tt_gaussian,
                                             tt_rademacher, tt_random_data,
                                             tt_to_dense)

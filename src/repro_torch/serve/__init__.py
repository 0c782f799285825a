"""Serving of the port (the twin of ``repro.serve``): LM prefill and decode
steps, the bitmap query step, and the async :class:`BitmapService` with its
background maintenance and resilience primitives."""
from repro_torch.serve.step import make_prefill_step, make_decode_step  # noqa: F401
from repro_torch.serve.step import make_bitmap_query_step  # noqa: F401
from repro_torch.serve.service import (BitmapService, DeadlineExceeded,  # noqa: F401
                                       QueryFuture, ServiceClosed,
                                       ServiceConfig, ServiceMetrics,
                                       ServiceOverloaded)
from repro_torch.serve.maintenance import (IndexMaintenance,  # noqa: F401
                                           MaintenanceExecutor)
from repro_torch.serve.resilience import (CircuitBreaker,  # noqa: F401
                                          RetryPolicy, is_transient)

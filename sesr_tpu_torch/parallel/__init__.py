"""Sharded execution on ``torch.distributed``: the port of sesr_tpu/parallel/.

``launch.py`` starts ranks on one host; ``tiling.py`` holds the (dp, sp)
and (dp, sph, spw) meshes and the sharded forwards; ``multihost.py`` the
host-major meshes, the tail forward and ``stream_frames``. The halo
exchange is ``ops/halo.py``, the windows of the deployment forwards
``ops/slab.py``.
"""

from sesr_tpu_torch.ops.halo import halo_exchange, halo_exchange_2d, halo_exchange_w
from sesr_tpu_torch.parallel.multihost import (make_mesh_multihost, multihost_integer_forward,
                                               multihost_packed_forward, stream_frames)
from sesr_tpu_torch.parallel.tiling import (make_mesh, make_mesh_2d, sharded_calibrate,
                                            sharded_deployment_forward,
                                            sharded_float_forward, sharded_float_forward_2d,
                                            sharded_hybrid_forward, sharded_integer_forward,
                                            sharded_integer_forward_2d, sharded_packed_forward)

"""The launch layer: the meshes (``mesh``), the serving front doors
(``render_service``, ``frontdoor``, ``tiles``), the model step builders,
serving loop and trainer (``steps``, ``serve``, ``train``), the sharding
rules, collectives and pipeline (``sharding``, ``collectives``,
``pipeline``), the dry-run and its step analysis (``dryrun``,
``step_analysis``), counterparts of ``repro/launch``."""

from repro_torch.launch.frontdoor import (AdmissionRejected, DeadlineExceeded,
                                          DispatchFailed, FrontDoor,
                                          FrontDoorError, FrontDoorStats,
                                          InvalidRequest, RenderedFrame,
                                          SessionClosed, TenantSession, Ticket)
from repro_torch.launch.mesh import FramesMesh, make_frames_mesh
from repro_torch.launch.render_service import (DEFAULT_FRAMES_PER_DEVICE,
                                               DEFAULT_PIPELINE_DEPTH,
                                               ChunkResult, ChunkStats,
                                               PlannedDispatch, RenderService,
                                               RenderStats, zoom_bounds)
from repro_torch.launch.tiles import (TileAddress, TileCache, TileResponse,
                                      TileService, quantize_index, tile_depth,
                                      tiles_for_viewport)

__all__ = ["FramesMesh", "make_frames_mesh", "RenderService", "RenderStats",
           "ChunkStats", "ChunkResult", "PlannedDispatch", "zoom_bounds",
           "DEFAULT_FRAMES_PER_DEVICE", "DEFAULT_PIPELINE_DEPTH", "FrontDoor",
           "FrontDoorStats", "TenantSession", "Ticket", "RenderedFrame",
           "FrontDoorError", "AdmissionRejected", "DeadlineExceeded",
           "InvalidRequest", "DispatchFailed", "SessionClosed", "TileAddress",
           "TileCache", "TileResponse", "TileService", "quantize_index",
           "tile_depth", "tiles_for_viewport"]

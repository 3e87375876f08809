"""CacheGen's store -> stream -> materialize flow (paper §5.3, Algorithm 1)."""
from repro_torch.streaming.adaptation import (  # noqa: F401
    TEXT,
    AdaptationPolicy,
    NoFeasibleConfigError,
    StreamConfig,
    choose_config,
    make_policy,
    salvage_credit,
)
from repro_torch.streaming.calibration import (  # noqa: F401
    measured_decode_bytes_per_s,
    measured_level_priorities,
)
from repro_torch.streaming.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    FaultyBackend,
    FaultyTransport,
    with_faulty_backend,
)
from repro_torch.streaming.network import (  # noqa: F401
    BandwidthTrace,
    FetchOutcome,
    NetworkModel,
    keyed_straggler_delay,
)
from repro_torch.streaming.pipeline import (  # noqa: F401
    ChunkTimeline,
    ContentionModel,
    StreamClock,
    StreamResult,
    remaining_work,
    simulate_stream,
)
from repro_torch.streaming.storage import (  # noqa: F401
    HASH_CHAIN_VERSION,
    ChunkMeta,
    DirectoryBackend,
    KVStore,
    MemoryBackend,
    StorageBackend,
    TieredKVStore,
    chain_hashes,
    split_chunks,
    token_payloads,
)
from repro_torch.streaming.streamer import (  # noqa: F401
    CacheGenStreamer,
    FetchPlan,
    PlanSegment,
    RunSegmenter,
    segment_plan,
)
from repro_torch.streaming.transport import (  # noqa: F401
    FetchError,
    FetchHandle,
    FetchResult,
    LocalTransport,
    RetryPolicy,
    Salvage,
    SimTransport,
    TcpStoreServer,
    TcpTransport,
    Transport,
    as_completed,
    classify_failure,
)

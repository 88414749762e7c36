from repro_torch.checkpoint.io import LayerStore  # noqa: F401
from repro_torch.checkpoint.bundle import (  # noqa: F401
    atomic_write, bundle_nbytes, read_bundle, read_header, write_bundle,
)
from repro_torch.checkpoint.integrity import (  # noqa: F401
    atomic_write_text, crc32c, fsync_dir, fsync_file,
)
from repro_torch.checkpoint.superbundle import (  # noqa: F401
    IntegrityError, SuperBundle, compact, drop_cache_entry, journal_path,
    migrate, read_super_header, recover_journal, set_cache_entry,
    write_superbundle,
)

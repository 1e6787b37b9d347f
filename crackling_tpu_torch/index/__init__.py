from .build import IsslIndex, build_index  # noqa: F401
from .extract import (  # noqa: F401
    encode_seq,
    extract_offtarget_sites,
    find_candidate_guides,
)
from .io import (  # noqa: F401
    load_native,
    read_reference_issl,
    save_native,
    write_reference_issl,
)
from .extract import (  # noqa: F401
    extract_offtarget_sites_seq,
    find_candidate_guides_seq,
)

"""PagedMap: spatially paged Gaussian storage and frustum-culled views
(:mod:`repro_torch.slam.map.paged`)."""

from repro_torch.slam.map.paged import (  # noqa: F401
    PAGE_LADDER,
    PageTable,
    PagedConfig,
    build_page_table,
    frustum_planes,
    gather_field,
    ladder_page_capacity,
    morton_keys,
    num_pages,
    page_distances,
    pages_visible,
    scatter_field,
    select_pages,
    validate_paged,
    view_rows,
    working_set,
)

"""Paged serving of the port: page allocator, requests, PagedEngine."""

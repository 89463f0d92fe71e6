"""KV01 fixture: leaked acquire, shared-page mutation, free on a held
request page."""


class LeakyCache:
    def __init__(self, pool):
        self.pool = pool
        self.refs = []

    def grab(self, rid, page_id):
        self.refs.append(self.pool.acquire(rid, page_id))


def mutate_shared(pool, rid, page_id):
    page = pool.acquire(rid, page_id, shared=True)
    page.tokens_used = 0
    return page


def free_held(pool, rid):
    for page in pool.request_pages(rid):
        pool.free(page.page_id)

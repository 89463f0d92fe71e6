"""KV01 clean fixture: balanced acquire/release, copy-on-write before
mutating a shared page, ownership dropped via release_request."""


class BalancedCache:
    def __init__(self, pool):
        self.pool = pool

    def grab(self, rid, page_id):
        return self.pool.acquire(rid, page_id)

    def drop(self, rid):
        self.pool.release_request(rid)


def mutate_private(pool, rid, page_id):
    page = pool.acquire(rid, page_id, shared=True)
    page = pool.copy_page(rid, page)
    page.tokens_used = 0
    pool.release_request(rid)
    return page

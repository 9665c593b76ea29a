"""The Arrow Flight data-plane client (``flight``): shuffle fetches from
other executors. The ``BallistaContext`` client comes with ROADMAP queue
1, item 9d."""

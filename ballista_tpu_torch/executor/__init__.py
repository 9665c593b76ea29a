"""The executor side of the distributed tier: the shuffle writer
(``shuffle.py``) and the shuffle reader (``reader.py``), over local files.
The executor process, Flight and push shuffle come with ROADMAP queue 1,
item 9c."""

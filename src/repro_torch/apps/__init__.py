from .analytics import ColumnTable, OrpheusLite, RowTable
from .blockchain import FlatStateProof, ForkBaseLedger, Tx
from .blockchain_kv import BucketTree, KVLedger, MerkleTrie
from .wiki import ForkBaseWiki, LiveWiki, RedisWiki
